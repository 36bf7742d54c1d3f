// Projective -> affine conversion on secp256k1 for Hopper (sm_90a):
// to_affine_kernel, the kernel of ec.to_affine on a card.
//
// It replaces no Pallas kernel: the JAX package converts with its plain
// field inversion (privacy_auction_tpu/ops/field.py `inv`, XLA ops), and
// so did the port (ops/field.py `inv` = `pow_const`, 334 field muls in
// fixed 4-bit windows).  It was added because every Fiat-Shamir challenge
// (nizk.fs_challenge -> ec.serialize_uncompressed -> ec.to_affine) ran that
// inversion as some 16,750 PyTorch kernels: the four of a SEAL step graph
// were 86% of its kernel nodes, and each eager phase launched them one by
// one from the host.
//
// Built by privacy_auction_tpu_torch/ops/cuda_ec.py as a library of its
// own (libpa_affine.so, one nvcc beside the others) and bound through
// ctypes: the extern "C" launcher takes raw device pointers and a CUDA
// stream, launches on that stream and returns cudaGetLastError().
//
// Per lane: z^-1 = z^(p-2) by libsecp256k1's addition chain for p - 2
// (secp256k1_fe_inv: 255 squarings and 15 multiplications, against the
// plain path's 334 muls), then x = X z^-1 and y = Y z^-1.  Z = 0 (infinity)
// gives z^-1 = 0 and so (0, 0), as the plain path's inv(0) = 0 does.  Every
// value is canonical, so the result equals the plain path's limb for limb.
//
// What bounds it: 32-bit multiplies, 255 squarings x 2 (36 + 9) + 17 muls
// x 2 (64 + 9) = 25,432 a lane over the card's 16.7e12 a second (2 us at
// 1,280 lanes), or the 384 + 256 B a lane moves over 3.35 TB/s, the
// larger.  At the 300-1,280 lanes of a challenge a launch is a few warps
// over 132 SMs, one a scheduler, so what sets its time is one lane's
// chain of 272 dependent field ops: tens of microseconds, against the
// milliseconds of host launches the plain inversion took.  The design
// shortens that chain and nothing else: the chain with the fewest field
// ops, squarings of 36 products (fe_sqr_fast), every product summed by
// column with the group kernels' short reduction (fe_mul_fast), one
// thread a lane.  The control flow is fixed (loops over public counts,
// the final reduction a select), so the time does not depend on Z.
#include <cuda_runtime.h>

#include <cstdint>

#include "ec_device.cuh"

namespace {

using pa::Fe;

constexpr int kThreads = 128;

__device__ __forceinline__ Fe sqr_n(Fe a, int n) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) a = pa::fe_sqr_fast(a);
  return a;
}

__device__ __forceinline__ Fe mul(const Fe& a, const Fe& b) {
  return pa::fe_mul_fast(a, b);
}

// a^(p-2): a^-1 for a != 0, and 0 for a = 0.  p - 2 is, from the top,
// 223 ones, a zero, 22 ones, four zeros, then 1, 0, 1, 1, 0, 1; x_k is
// a^(2^k - 1), k ones, from the chain 1, 2, 3, 6, 9, 11, 22, 44, 88, 176,
// 220, 223 (tests/torch_inv_chain.py runs the same steps on integers).
__device__ Fe fe_inv(const Fe& a) {
  const Fe x2 = mul(sqr_n(a, 1), a);
  const Fe x3 = mul(sqr_n(x2, 1), a);
  const Fe x6 = mul(sqr_n(x3, 3), x3);
  const Fe x9 = mul(sqr_n(x6, 3), x3);
  const Fe x11 = mul(sqr_n(x9, 2), x2);
  const Fe x22 = mul(sqr_n(x11, 11), x11);
  const Fe x44 = mul(sqr_n(x22, 22), x22);
  const Fe x88 = mul(sqr_n(x44, 44), x44);
  const Fe x176 = mul(sqr_n(x88, 88), x88);
  const Fe x220 = mul(sqr_n(x176, 44), x44);
  const Fe x223 = mul(sqr_n(x220, 3), x3);
  Fe t = mul(sqr_n(x223, 23), x22);
  t = mul(sqr_n(t, 5), a);
  t = mul(sqr_n(t, 3), x2);
  return mul(sqr_n(t, 2), a);
}

// One lane: the (3, 16) int64 limbs of X, Y, Z -> the (2, 16) of x, y.
__device__ __forceinline__ void to_affine_lane(const int64_t* P, int64_t* out) {
  const Fe zinv = fe_inv(pa::fe_load_limbs(P + 32));
  pa::fe_store_limbs(out, mul(pa::fe_load_limbs(P), zinv));
  pa::fe_store_limbs(out + 16, mul(pa::fe_load_limbs(P + 16), zinv));
}

// ---- the kernel

__global__ void __launch_bounds__(kThreads)
to_affine_kernel(const int64_t* __restrict__ P, int64_t* __restrict__ out,
                 int n) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane < n) to_affine_lane(P + (size_t)lane * 48, out + (size_t)lane * 32);
}

}  // namespace

extern "C" {

// (n, 3, 16) int64 projective limbs, canonical, -> (n, 2, 16) int64 affine
// limbs, canonical; one thread a lane, kThreads a block.
int pa_to_affine(const int64_t* P, int64_t* out, int n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  to_affine_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                     (cudaStream_t)stream>>>(P, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
