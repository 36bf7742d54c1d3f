// The EC kernels of the port, for Hopper (sm_90a): the four ladders of the
// SEAL and CCS22 auctions' path (mul_comb, dual_mul at 33 windows, quad_mul,
// base_mul_add_glv) and the three kernels that only the kernel validator and
// the ladder bench reach (scalar_mul and dual_mul at 64 windows, the non-GLV
// base_mul_add, and pt_add).
//
// Built by privacy_auction_tpu_torch/ops/cuda_ec.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through ctypes: each extern "C" launcher below takes raw device
// pointers and a CUDA stream, launches on that stream and returns
// cudaGetLastError().
//
// quad_mul and base_mul_add_glv, the two kernels with the most launches x
// time on the SEAL path, have the Hopper design of ec_group.cuh: several
// threads per lane, window tables in shared memory.  The five others keep
// the first, simple design:
//  * one thread per lane, 128 threads per block, a grid over the lanes with
//    the ragged edge masked; nothing is padded;
//  * inputs are the port's int64 16-bit limbs ((n, 3, 16) points, (n, 16)
//    scalars), repacked to 8 x 32-bit words on load; 4-bit window digits are
//    read from the scalar limbs in the kernel, least significant first;
//  * per-lane window tables [inf, P, ..., 15P] live in local memory
//    (1.5 KiB each); lookups by secret digit read all 16 entries and mask
//    (pt_select16, straight-line code that chip_smoke.py checks in SASS);
//  * constant tables (comb table, window-0 tables of G and phi(G)) come as
//    32-bit words in device memory; every lane reads the same entries, which
//    replaces the TPU's exact one-hot f32 MXU matmuls.
//
// What bounds the ladders: 32-bit integer multiplies (pt_add, one add per
// lane, is bound by its bytes instead; see its note).  One field mul is an 8x8
// schoolbook of 64 wide (32x32->64) products plus 9 for the fold by
// 2^32 + 977; cuda_ec.int_muls() counts, per lane from the ladder shape,
// what the formulas need (squarings at 36 products, muls by 2 and 8 as
// shifts), which is less than these kernels do.
// Latency, not throughput, limits the simple design: the auction gives a
// kernel a few thousand lanes, tens of blocks on 132 SMs, and each thread
// runs a long dependent chain with its tables spilled to local memory.
//
// What it leaves on the table: PTX carry chains (mad.lo.cc/madc.hi) in
// place of 64-bit accumulators, tables in shared memory and several
// threads per lane (as ec_group.cuh does), and signed-digit windows (8
// entries per table instead of 16).
#include <cuda_runtime.h>

#include <cstdint>

#include "ec_device.cuh"
#include "ec_group.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kCombWindows = 64;  // 4-bit windows of a 256-bit scalar

using pa::Pt;

// ---------------------------------------------------------------------------
// mul_comb: k*B over a (64, 16, 3, 8)-word comb table of B.
// Replaces _mul_base_kernel (privacy_auction_tpu/ops/pallas_ec.py:538).
// Per lane: 64 complete adds (64 * 12 field muls).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
mul_comb_kernel(const int64_t* __restrict__ k, const uint32_t* __restrict__ table,
                int64_t* __restrict__ out, int n) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;
  const int64_t* kl = k + (size_t)lane * 16;
  Pt acc = pa::pt_infinity();
#pragma unroll 1
  for (int w = 0; w < kCombWindows; ++w) {
    const uint32_t d = pa::scalar_digit(kl, w);
    const Pt* tw = reinterpret_cast<const Pt*>(table) + w * 16;
    acc = pa::pt_add(acc, pa::pt_select16(tw, d));
  }
  pa::pt_store_limbs(out + (size_t)lane * 48, acc);
}

// ---------------------------------------------------------------------------
// Straus ladder: sum of S k_i*P_i over `windows` 4-bit windows, one shared
// doubling chain.  Per lane: S * 14 table adds + windows * (4 doublings +
// S adds); S tables of 16 entries (1.5 KiB each) in local memory.
//  * scalar_mul (S = 1): k*P over 64 windows, the plain ladder without GLV.
//    Replaces _scalar_mul_kernel (privacy_auction_tpu/ops/pallas_ec.py:346).
//  * dual_mul (S = 2): k1*P1 + k2*P2, at 33 windows for the GLV halves of
//    scalar_mul, and at 64 windows on full scalars (kp*P + kq*Q without
//    GLV).  Replaces _dual_mul_kernel (privacy_auction_tpu/ops/pallas_ec.py:366)
//    at both window counts.
// ---------------------------------------------------------------------------
template <int S>
struct StrausArgs {
  const int64_t* P[S];
  const int64_t* k[S];
  int64_t* out;
  int n;
  int windows;
};

template <int S>
__device__ __forceinline__ void straus(const StrausArgs<S>& a) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= a.n) return;
  Pt T[S][16];
#pragma unroll 1
  for (int s = 0; s < S; ++s)
    pa::pt_fill_table(T[s], pa::pt_load_limbs(a.P[s] + (size_t)lane * 48));
  Pt acc = pa::pt_infinity();
#pragma unroll 1
  for (int w = a.windows - 1; w >= 0; --w) {
    acc = pa::pt_dbl4(acc);
#pragma unroll 1
    for (int s = 0; s < S; ++s)
      acc = pa::pt_add(acc, pa::pt_select16(
                                T[s], pa::scalar_digit(a.k[s] + (size_t)lane * 16, w)));
  }
  pa::pt_store_limbs(a.out + (size_t)lane * 48, acc);
}

__global__ void __launch_bounds__(kThreads) scalar_mul_kernel(StrausArgs<1> a) {
  straus(a);
}

__global__ void __launch_bounds__(kThreads) dual_mul_kernel(StrausArgs<2> a) {
  straus(a);
}

// ---------------------------------------------------------------------------
// quad_mul: sum of four k_i*P_i over GLV half-scalars, and base_mul_add_glv:
// g^s * P^t with both scalars GLV-split, on the group ladder of
// ec_group.cuh (several threads per lane, tables in shared memory).
//  * quad_mul replaces _quad_mul_kernel (privacy_auction_tpu/ops/pallas_ec.py:404).
//  * base_mul_add_glv replaces _base_mul_add_glv_kernel
//    (privacy_auction_tpu/ops/pallas_ec.py:436).  P1/P2 are the
//    sign-adjusted +-P / +-phi(P) with magnitudes t1/t2; s1/s2 the
//    magnitudes of s's halves with signs in sflags (n, 2).  The generator
//    side reads the constant window-0 tables of G and phi(G) (affine,
//    Z = 1) and negates the fetched Y where the lane's sign flag is set:
//    any (0:y:0) is a valid infinity for the complete formulas.
// ---------------------------------------------------------------------------
// Threads a lane, G = 8 or 4, chosen by the wrapper from the launch's lanes
// (cuda_ec.launch_shape): up to 2,048 lanes the launch is a few warps an
// SM, latency-bound, and 8 threads take an add in two rounds of muls, not
// four; above that 4 threads do less work in all and keep the card busy
// (measured on the H100: PERF.md, Findings).
template <int G>
__global__ void __launch_bounds__(pa::grp::kWarp) quad_mul_kernel(pa::grp::Args a) {
  pa::grp::straus_group<false, G>(a);
}

template <int G>
__global__ void __launch_bounds__(pa::grp::kWarp) base_mul_add_glv_kernel(pa::grp::Args a) {
  pa::grp::straus_group<true, G>(a);
}

// Launch a group kernel with the shape the wrapper computed
// (cuda_ec.launch_shape); a shape that differs from this build's is refused.
template <bool kGlv, int G>
int launch_group(const pa::grp::Args& a, int blocks, int threads, int smem, void* stream) {
  using S = pa::grp::Shape<G>;
  const int want_smem = kGlv ? S::kGlvSmem : S::kQuadSmem;
  if (blocks != S::blocks(a.n) || threads != pa::grp::kWarp || smem != want_smem)
    return (int)cudaErrorInvalidValue;
  const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  const cudaError_t err = kGlv ? cudaFuncSetAttribute(base_mul_add_glv_kernel<G>, attr, smem)
                               : cudaFuncSetAttribute(quad_mul_kernel<G>, attr, smem);
  if (err != cudaSuccess) return (int)err;
  if constexpr (kGlv)
    base_mul_add_glv_kernel<G><<<blocks, threads, smem, (cudaStream_t)stream>>>(a);
  else
    quad_mul_kernel<G><<<blocks, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kGlv>
int launch_group(const pa::grp::Args& a, int group, int blocks, int threads, int smem,
                 void* stream) {
  if (a.n <= 0) return (int)cudaGetLastError();
  if (group == 8) return launch_group<kGlv, 8>(a, blocks, threads, smem, stream);
  if (group == 4) return launch_group<kGlv, 4>(a, blocks, threads, smem, stream);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// base_mul_add: g^s * P^t without GLV, one doubling chain over the 64
// 4-bit windows of the full scalars.
// Replaces _base_mul_add_kernel (privacy_auction_tpu/ops/pallas_ec.py:496).
// Per window, in the TPU kernel's order: 4 doublings, the add of the
// constant window-0 entry s_w*G (affine, Z = 1; read from device memory with
// the masked select, every lane the same addresses), then the add of the
// per-lane entry t_w*P.  Per lane: 14 table adds + 64 * (4 doublings +
// 2 adds); one 1.5 KiB table in local memory.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
base_mul_add_kernel(const int64_t* __restrict__ P, const int64_t* __restrict__ t,
                    const int64_t* __restrict__ s, const uint32_t* __restrict__ g0,
                    int64_t* __restrict__ out, int n) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;
  Pt T[16];
  pa::pt_fill_table(T, pa::pt_load_limbs(P + (size_t)lane * 48));
  const int64_t* tl = t + (size_t)lane * 16;
  const int64_t* sl = s + (size_t)lane * 16;
  const Pt* G = reinterpret_cast<const Pt*>(g0);
  Pt acc = pa::pt_infinity();
#pragma unroll 1
  for (int w = kCombWindows - 1; w >= 0; --w) {
    acc = pa::pt_dbl4(acc);
    acc = pa::pt_add(acc, pa::pt_select16(G, pa::scalar_digit(sl, w)));
    acc = pa::pt_add(acc, pa::pt_select16(T, pa::scalar_digit(tl, w)));
  }
  pa::pt_store_limbs(out + (size_t)lane * 48, acc);
}

// ---------------------------------------------------------------------------
// pt_add: one complete RCB16 Alg 7 add P + Q per lane, the sequence of the
// plain ec.add.  Replaces _pt_add_kernel (privacy_auction_tpu/ops/pallas_ec.py:399).
// Bound by bytes, not multiplies: a lane moves 1,152 B as int64 limbs (two
// 384 B points read, one written) for 12 field muls, so at 3.35 TB/s the
// memory takes about 3x the multiply time.  One thread per lane reads its
// own 48 limbs; the layout conversion keeps the package's int64 format, which
// is 4x the bytes of packed 32-bit words.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
pt_add_kernel(const int64_t* __restrict__ P, const int64_t* __restrict__ Q,
              int64_t* __restrict__ out, int n) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;
  pa::pt_store_limbs(out + (size_t)lane * 48,
                     pa::pt_add(pa::pt_load_limbs(P + (size_t)lane * 48),
                                pa::pt_load_limbs(Q + (size_t)lane * 48)));
}

inline int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

int pa_mul_comb(const int64_t* k, const uint32_t* table, int64_t* out, int n,
                void* stream) {
  if (n > 0)
    mul_comb_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(k, table, out, n);
  return (int)cudaGetLastError();
}

int pa_scalar_mul(const int64_t* P, const int64_t* k, int64_t* out, int n,
                  int windows, void* stream) {
  StrausArgs<1> a{{P}, {k}, out, n, windows};
  if (n > 0) scalar_mul_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

int pa_dual_mul(const int64_t* P1, const int64_t* k1, const int64_t* P2,
                const int64_t* k2, int64_t* out, int n, int windows, void* stream) {
  StrausArgs<2> a{{P1, P2}, {k1, k2}, out, n, windows};
  if (n > 0) dual_mul_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

int pa_quad_mul(const int64_t* P1, const int64_t* k1, const int64_t* P2,
                const int64_t* k2, const int64_t* P3, const int64_t* k3,
                const int64_t* P4, const int64_t* k4, int64_t* out, int n,
                int windows, int group, int blocks, int threads, int smem,
                void* stream) {
  pa::grp::Args a{{P1, P2, P3, P4}, {k1, k2, k3, k4}, nullptr, nullptr, out, n, windows};
  return launch_group<false>(a, group, blocks, threads, smem, stream);
}

int pa_base_mul_add_glv(const int64_t* P1, const int64_t* t1, const int64_t* P2,
                        const int64_t* t2, const int64_t* s1, const int64_t* s2,
                        const int64_t* sflags, const uint32_t* g0, int64_t* out,
                        int n, int windows, int group, int blocks, int threads,
                        int smem, void* stream) {
  pa::grp::Args a{{nullptr, nullptr, P1, P2}, {s1, s2, t1, t2}, sflags, g0, out, n, windows};
  return launch_group<true>(a, group, blocks, threads, smem, stream);
}

int pa_base_mul_add(const int64_t* P, const int64_t* t, const int64_t* s,
                    const uint32_t* g0, int64_t* out, int n, void* stream) {
  if (n > 0)
    base_mul_add_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        P, t, s, g0, out, n);
  return (int)cudaGetLastError();
}

int pa_pt_add(const int64_t* P, const int64_t* Q, int64_t* out, int n, void* stream) {
  if (n > 0)
    pt_add_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(P, Q, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
