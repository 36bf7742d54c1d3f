"""Clocks a round of the SHA-256 kernel on the card, read by the kernel.

    python tools/sha256_clocks_torch.py [--root DIR]

Builds a copy of DIR's `privacy_auction_tpu_torch/csrc/sha256.cu` (this
checkout by default) with two reads of clock64() added to the consumer
warp: after its first fill arrives and after its last round; thread 0 of
each block keeps the difference.  Runs the copy at SHAPES on random bytes,
checks each digest against hashlib, and prints the card's name and power
limit and one JSON line {"root", "card", "clocks_a_round": {"lanes x
bytes": clocks}}: the slowest block's clocks over its blocks x 64 rounds,
in SM clocks, without the launch, the first fill's wait or host time.  The
copy and its library go to build/sha256_clocks/ of this checkout; the
kernel's own build is not touched.  Needs nvcc and a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import pathlib
import subprocess
import sys

# (lanes, message bytes): a Stage1 transcript at SEAL 20x32 (unaligned
# rows), CCS22 1024x64's bidder messages, and the one-lane evaluator
# messages of CCS22 20x32 and 1024x64
SHAPES = ((20, 1066), (1024, 8192), (1, 24576), (1, 2105344))
MAX_BLOCKS = 4096   # of the grid: 32 lanes a block

# (anchor, what goes after it) in the kernel's source
PROBES = (
    ("namespace {\n", f"__device__ long long g_clocks[{MAX_BLOCKS}];\n"),
    ("  bar_sync(kFullBar + ring_slot(fill_awaited(0, L)));\n",
     "  const long long clock0 = clock64();\n"),
    ("    if (released >= 0) bar_arrive(kEmptyBar + ring_slot(released));\n"
     "  }\n",
     "  if (t == 0) g_clocks[cta] = clock64() - clock0;\n"),
    ('extern "C" {\n',
     "int pa_sha256_clocks(long long* dst, int n) {\n"
     "  return (int)cudaMemcpyFromSymbol(dst, g_clocks, n * sizeof(long long));\n"
     "}\n"),
)


def probed(source: str) -> str:
    """The kernel's source with the clock reads of PROBES added."""
    for anchor, added in PROBES:
        if source.count(anchor) != 1:
            raise SystemExit(f"sha256_clocks_torch: {anchor!r} is not in the "
                             "kernel's source once; update PROBES")
        source = source.replace(anchor, anchor + added)
    return source


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[1]))
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("sha256_clocks_torch: no CUDA device")
    from privacy_auction_tpu_torch.ops import cuda_ec

    out_dir = pathlib.Path(__file__).resolve().parents[1] / "build" / "sha256_clocks"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "sha256_clocks.cu"
    src.write_text(probed((cuda_ec.CSRC / "sha256.cu").read_text()))
    lib_path = out_dir / "libsha256_clocks.so"
    subprocess.run([cuda_ec._nvcc(), *cuda_ec.NVCC_FLAGS, "-o", str(lib_path),
                    str(src)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.pa_sha256.argtypes = [P, P, L, L, I, I, P]
    lib.pa_sha256_clocks.argtypes = [P, I]

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    clocks = {}
    for lanes, length in SHAPES:
        msg = torch.randint(0, 256, (lanes, length), generator=gen,
                            dtype=torch.uint8)
        m = msg.to(dev)
        out = torch.empty((lanes, 8), dtype=torch.int64, device=dev)
        blocks = cuda_ec.sha256_blocks(length)
        grid = -(-lanes // cuda_ec.WARP)
        for _ in range(2):      # the second launch is read
            rc = lib.pa_sha256(m.data_ptr(), out.data_ptr(), lanes, length,
                               cuda_ec.SHA256_THREADS, int(length % 4 == 0),
                               stream)
            torch.cuda.synchronize()
            if rc:
                raise RuntimeError(f"pa_sha256 returned CUDA error {rc}")
        got = out.cpu().tolist()
        for i, row in enumerate(msg.numpy()):
            digest = hashlib.sha256(row.tobytes()).digest()
            if got[i] != [int.from_bytes(digest[4 * j:4 * j + 4], "big")
                          for j in range(8)]:
                raise AssertionError(f"{lanes} x {length} B: lane {i} differs "
                                     "from hashlib")
        per_block = (ctypes.c_longlong * grid)()
        rc = lib.pa_sha256_clocks(ctypes.addressof(per_block), grid)
        if rc:
            raise RuntimeError(f"pa_sha256_clocks returned CUDA error {rc}")
        clocks[f"{lanes}x{length}"] = max(per_block) / (blocks * 64)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"root": str(root), "card": torch.cuda.get_device_name(0),
                      "clocks_a_round": clocks}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
