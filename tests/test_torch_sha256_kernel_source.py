"""The SHA-256 kernel's source (`privacy_auction_tpu_torch/csrc/sha256.cu`)
compiled by the host's C++ compiler and run on the CPU, against hashlib.

There is no nvcc here, so the kernel's code is compiled as host C++: the
CUDA keywords are defined away, the intrinsics it uses (`__ldg`,
`__funnelshift_r`, `__byte_perm`, `clock64`) get host definitions of what
the CUDA programming guide says they compute, the launchers (everything
from `extern "C"`) are dropped, and a host loop calls `sha256_kernel` once
a lane with `blockIdx` and `threadIdx` set.  This holds the kernel's own
block walk, in-kernel padding and word assembly (whole words on aligned
rows, bytes otherwise) to hashlib at every length across the block
boundaries; on the card chip_smoke.py holds the compiled kernel to its
plain version and hashlib."""

import ctypes
import hashlib
import pathlib
import shutil
import subprocess

import numpy as np
import pytest

SOURCE = (pathlib.Path(__file__).resolve().parents[1] / "privacy_auction_tpu_torch"
          / "csrc" / "sha256.cu")

STUB = r"""
#include <cstdint>
#include <cstring>
#define __device__
#define __forceinline__ inline
#define __global__
#define __constant__
#define __restrict__
struct Dim { unsigned x; };
static Dim blockIdx, threadIdx, blockDim;
static inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, int k) {
  k &= 31;
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> k);
}
static inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  uint8_t b[8];
  memcpy(b, &x, 4);
  memcpy(b + 4, &y, 4);
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i) r |= (uint32_t)b[(s >> (4 * i)) & 7] << (8 * i);
  return r;
}
template <class T> static inline T __ldg(const T* p) { return *p; }
static inline long long clock64() { return 0; }
"""

RUN = r"""
extern "C" void run(const uint8_t* msg, int64_t* out, long long lanes,
                    long long len, int aligned) {
  const long long blocks = (len + 9 + 63) / 64;
  blockDim.x = 64;
  for (long long l = 0; l < lanes; ++l) {
    blockIdx.x = (unsigned)(l / 64);
    threadIdx.x = (unsigned)(l % 64);
    K::sha256_kernel(msg, out, lanes, len, blocks, aligned != 0);
  }
}
"""


def _host_library(tmp_path):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    src = SOURCE.read_text()
    src = src.replace("#include <cuda_runtime.h>", STUB)
    src = src[:src.index('extern "C"')].replace("namespace {", "namespace K {", 1)
    path = tmp_path / "sha256_host.cc"
    path.write_text(src + RUN)
    lib = tmp_path / "libsha256_host.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-o", str(lib),
                    str(path)], check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    dll.run.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                        ctypes.c_longlong, ctypes.c_int]
    return dll


def test_kernel_source_matches_hashlib_on_the_host(tmp_path):
    dll = _host_library(tmp_path)
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
