"""The SHA-256 kernel's source (`privacy_auction_tpu_torch/csrc/sha256.cu`)
compiled by the host's C++ compiler and run on the CPU, against hashlib.

The harness (tests/torch_sha256_host.py) compiles the kernel's device
functions as host C++ and calls them in the kernel's order, a lane at a
time: the producer's `produce_block` (the block's bytes as whole words on
aligned rows, bytes otherwise, the padding made in place, the 48 scheduled
words and K added), then the consumer's `consume_block` (the 64 rounds on
K + W, eight an iteration).  This holds that arithmetic to hashlib at every
length across the block boundaries, aligned and not, after parsing the
whole source up to its launchers (the kernel's roles and barriers); on the
card chip_smoke.py holds the compiled kernel to its plain version and
hashlib."""

import hashlib

import numpy as np

from torch_sha256_host import host_library, syntax_check


def test_kernel_source_matches_hashlib_on_the_host(tmp_path):
    syntax_check(tmp_path)
    dll = host_library(tmp_path)
    rng = np.random.default_rng(10)
    lanes = 3
    lengths = list(range(0, 200)) + [218, 543, 1066, 1846, 4096, 24576 + 4]
    for length in lengths:
        for aligned in (0, 1):
            if aligned and length % 4:
                continue
            msgs = rng.integers(0, 256, size=(lanes, length), dtype=np.uint8)
            # an unaligned run starts the rows one byte into the buffer
            buf = np.zeros(lanes * length + 8, dtype=np.uint8)
            start = buf.ctypes.data + (0 if aligned else 1)
            off = start - buf.ctypes.data
            buf[off:off + lanes * length] = msgs.reshape(-1)
            out = np.zeros((lanes, 8), dtype=np.int64)
            dll.run(start, out.ctypes.data, lanes, length, aligned)
            for i in range(lanes):
                want = np.frombuffer(hashlib.sha256(msgs[i].tobytes()).digest(),
                                     ">u4").astype(np.int64)
                np.testing.assert_array_equal(
                    out[i], want, err_msg=f"{length} B, aligned={aligned}")
