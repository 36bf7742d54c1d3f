"""The SHA-256 kernel's source (`privacy_auction_tpu_torch/csrc/sha256.cu`)
compiled by the host's C++ compiler, for tests on the CPU.

There is no nvcc here, so the kernel's code is compiled as host C++: the
CUDA keywords are defined away and the intrinsics it uses (`__ldg`,
`__funnelshift_r`, `__byte_perm`, `__clz`, `clock64`, `__syncwarp`) get host
definitions of what the CUDA programming guide says they compute.
`syntax_check` parses the whole source before the launchers (the kernels
and their barriers included); `host_library` compiles its device functions
(everything before the kernels) with extern "C" shims:

- `run(msg, out, lanes, len, aligned)`: each lane's message through the
  producer's `produce_block` (bytes -> K + W, the padding made in place) and
  the consumer's `consume_block` (the rounds), block after block, the
  digest words into `out` (lanes, 8) int64;
- the work split of the ring, one shim a function: `cta_lanes`,
  `ring_fills`, `ring_slot`, `ring_pair`, `block_fill`, `block_column`,
  `fill_awaited`, `fill_released`, `fill_reused`, and `slots()`,
  `producers()` (the kernel's kSlots and kProducers).
"""

import ctypes
import pathlib
import shutil
import subprocess

import pytest

SOURCE = (pathlib.Path(__file__).resolve().parents[1] / "privacy_auction_tpu_torch"
          / "csrc" / "sha256.cu")
KERNELS = "// ---- the kernel"

STUB = r"""
#include <cstdint>
#include <cstring>
#define __device__
#define __forceinline__ inline
#define __global__
#define __constant__
#define __restrict__
#define __shared__
#define __launch_bounds__(x)
struct Dim { unsigned x; };
static Dim blockIdx, threadIdx, blockDim;
typedef void* cudaStream_t;
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
static inline void __syncwarp() {}
static inline int __clz(int x) { return x ? __builtin_clz((unsigned)x) : 32; }
"""

SHIMS = r"""
extern "C" {
void run(const uint8_t* msg, int64_t* out, long long lanes, long long len,
         int aligned) {
  const long long blocks = (len + 9 + 63) / 64;
  for (long long l = 0; l < lanes; ++l) {
    const uint8_t* row = msg + l * len;
    uint32_t st[8], kw[64];
    for (int i = 0; i < 8; ++i) st[i] = K::kH0[i];
    for (long long b = 0; b < blocks; ++b) {
      K::produce_block(row, len, b, aligned != 0, kw, 1);
      K::consume_block(st, kw, 1);
    }
    for (int i = 0; i < 8; ++i) out[l * 8 + i] = (int64_t)st[i];
  }
}
int cta_lanes(long long lanes, long long cta) { return K::cta_lanes(lanes, cta); }
long long ring_fills(long long blocks, int L) { return K::ring_fills(blocks, L); }
int ring_slot(long long f) { return K::ring_slot(f); }
int ring_pair(int p, int L, long long f, long long blocks, int* lane,
              long long* block) {
  return K::ring_pair(p, L, f, blocks, lane, block);
}
long long block_fill(long long b, int L) { return K::block_fill(b, L); }
int block_column(int l, int L, long long b) { return K::block_column(l, L, b); }
long long fill_awaited(long long b, int L) { return K::fill_awaited(b, L); }
long long fill_released(long long b, int L, long long blocks) {
  return K::fill_released(b, L, blocks);
}
long long fill_reused(long long f) { return K::fill_reused(f); }
int slots() { return K::kSlots; }
int producers() { return K::kProducers; }
}
"""


def _cxx() -> str:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    return cxx


def _source(end: str) -> str:
    src = SOURCE.read_text()
    src = src.replace("#include <cuda_runtime.h>", STUB)
    return src[:src.index(end)].replace("namespace {", "namespace K {", 1)


def syntax_check(tmp_path):
    """Parse the source up to its launchers (the kernels, their shared
    memory and barriers included) with the host compiler; raises on an
    error."""
    path = tmp_path / "sha256_syntax.cc"
    path.write_text(_source('extern "C"'))
    subprocess.run([_cxx(), "-std=c++17", "-fsyntax-only", str(path)],
                   check=True, capture_output=True, text=True)


def host_library(tmp_path) -> ctypes.CDLL:
    """The device functions compiled for the host, with the shims above."""
    path = tmp_path / "sha256_host.cc"
    path.write_text(_source(KERNELS) + "}  // namespace K\n" + SHIMS)
    lib = tmp_path / "libsha256_host.so"
    subprocess.run([_cxx(), "-std=c++17", "-O1", "-shared", "-fPIC", "-o",
                    str(lib), str(path)], check=True, capture_output=True,
                   text=True)
    dll = ctypes.CDLL(str(lib))
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    dll.run.argtypes = [P, P, LL, LL, I]
    dll.cta_lanes.argtypes = [LL, LL]
    dll.ring_fills.argtypes = [LL, I]
    dll.ring_fills.restype = LL
    dll.ring_slot.argtypes = [LL]
    dll.ring_pair.argtypes = [I, I, LL, LL, ctypes.POINTER(I),
                              ctypes.POINTER(LL)]
    dll.block_fill.argtypes = [LL, I]
    dll.block_fill.restype = LL
    dll.block_column.argtypes = [I, I, LL]
    dll.fill_awaited.argtypes = [LL, I]
    dll.fill_awaited.restype = LL
    dll.fill_released.argtypes = [LL, I, LL]
    dll.fill_released.restype = LL
    dll.fill_reused.argtypes = [LL]
    dll.fill_reused.restype = LL
    return dll
