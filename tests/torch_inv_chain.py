"""The projective-to-affine kernel (`privacy_auction_tpu_torch/csrc/
ec_affine.cu`) on the CPU, for tests: its addition chain for p - 2 on
Python integers, and its device functions compiled by the host's C++
compiler.

`CHAIN` is the kernel's `fe_inv`, step for step: each step squares its base
`squarings` times and multiplies by its operand into its result, in the
kernel's order (libsecp256k1's `secp256k1_fe_inv`).  `inv_chain` runs the
steps on an integer mod p and counts the squarings and multiplications;
`chain_exponent` runs them on exponents, the power of a the chain reaches.

There is no nvcc here, so `host_library` compiles the kernel's source up to
the kernel itself as host C++ (the CUDA keywords defined away, as
tests/torch_sha256_host.py does for SHA-256) with extern "C" shims, each
over n lanes of int64 16-bit limbs: `sqr` (fe_sqr_fast), `mul`
(fe_mul_fast), `inv` (fe_inv) on (n, 16) elements, and `to_affine`
(to_affine_lane) on (n, 3, 16) points into (n, 2, 16).
"""

import ctypes
import pathlib
import shutil
import subprocess

import pytest

CSRC = pathlib.Path(__file__).resolve().parents[1] / "privacy_auction_tpu_torch" / "csrc"
SOURCE = CSRC / "ec_affine.cu"
KERNEL = "// ---- the kernel"

# (result, base, squarings, operand): result = base^(2^squarings) * operand
CHAIN = (
    ("x2", "a", 1, "a"),
    ("x3", "x2", 1, "a"),
    ("x6", "x3", 3, "x3"),
    ("x9", "x6", 3, "x3"),
    ("x11", "x9", 2, "x2"),
    ("x22", "x11", 11, "x11"),
    ("x44", "x22", 22, "x22"),
    ("x88", "x44", 44, "x44"),
    ("x176", "x88", 88, "x88"),
    ("x220", "x176", 44, "x44"),
    ("x223", "x220", 3, "x3"),
    ("t", "x223", 23, "x22"),
    ("t", "t", 5, "a"),
    ("t", "t", 3, "x2"),
    ("t", "t", 2, "a"),
)


def _run(a, square, times):
    vals = {"a": a}
    for out, base, n, operand in CHAIN:
        v = vals[base]
        for _ in range(n):
            v = square(v)
        vals[out] = times(v, vals[operand])
    return vals["t"]


def inv_chain(a: int, p: int) -> tuple[int, int, int]:
    """(a^(p-2) mod p by the chain, its squarings, its multiplications)."""
    counts = [0, 0]

    def square(v):
        counts[0] += 1
        return v * v % p

    def times(v, w):
        counts[1] += 1
        return v * w % p

    return _run(a % p, square, times), counts[0], counts[1]


def chain_exponent() -> int:
    """The e of a^e that the chain computes."""
    return _run(1, lambda e: 2 * e, lambda e, f: e + f)


STUB = r"""
#include <cstdint>
#define __device__
#define __forceinline__ inline
#define __noinline__
"""

SHIMS = r"""
extern "C" {
void sqr(const int64_t* a, int64_t* out, int n) {
  for (int i = 0; i < n; ++i)
    pa::fe_store_limbs(out + 16 * i, pa::fe_sqr_fast(pa::fe_load_limbs(a + 16 * i)));
}
void mul(const int64_t* a, const int64_t* b, int64_t* out, int n) {
  for (int i = 0; i < n; ++i)
    pa::fe_store_limbs(out + 16 * i, pa::fe_mul_fast(pa::fe_load_limbs(a + 16 * i),
                                                     pa::fe_load_limbs(b + 16 * i)));
}
void inv(const int64_t* a, int64_t* out, int n) {
  for (int i = 0; i < n; ++i)
    pa::fe_store_limbs(out + 16 * i, K::fe_inv(pa::fe_load_limbs(a + 16 * i)));
}
void to_affine(const int64_t* P, int64_t* out, int n) {
  for (int i = 0; i < n; ++i) K::to_affine_lane(P + 48 * i, out + 32 * i);
}
}
"""


def host_library(tmp_path) -> ctypes.CDLL:
    """The kernel's device functions compiled for the host, with the shims
    above."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    src = SOURCE.read_text().replace("#include <cuda_runtime.h>", STUB)
    src = src[:src.index(KERNEL)].replace("namespace {", "namespace K {", 1)
    path = tmp_path / "ec_affine_host.cc"
    path.write_text(src + "}  // namespace K\n" + SHIMS)
    lib = tmp_path / "libec_affine_host.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-Wno-unknown-pragmas", "-shared",
                    "-fPIC", "-I", str(CSRC), "-o", str(lib), str(path)],
                   check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    dll.sqr.argtypes = dll.inv.argtypes = dll.to_affine.argtypes = [P, P, I]
    dll.mul.argtypes = [P, P, P, I]
    return dll
