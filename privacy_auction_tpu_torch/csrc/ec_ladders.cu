// The EC kernels of the port, for Hopper (sm_90a): the four ladders of the
// SEAL and CCS22 auctions' path (mul_comb, dual_mul at 33 windows, quad_mul,
// base_mul_add_glv) and the kernels that only the kernel validator and the
// ladder bench reach (scalar_mul, the non-GLV base_mul_add, dual_mul at 64
// windows, and pt_add).
//
// Built by privacy_auction_tpu_torch/ops/cuda_ec.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through ctypes: each extern "C" launcher below takes raw device
// pointers and a CUDA stream, launches on that stream and returns
// cudaGetLastError().
//
// Every kernel that looks up window tables has the Hopper design of
// ec_group.cuh: several threads per lane, window tables in shared memory;
// their launchers take the launch shape the wrapper computed
// (cuda_ec.launch_shape) and refuse one that does not fit the build.
// Inputs are the port's int64 16-bit limbs ((n, 3, 16) points, (n, 16)
// scalars), repacked to 8 x 32-bit words on load; 4-bit window digits are
// read from the scalar limbs in the kernel, least significant first.
// pt_add, one add a lane, runs on the same group add: G threads a lane, one
// warp a block, the block's lanes staged through shared memory.
//
// What bounds the ladders: 32-bit integer multiplies (pt_add is bound by
// its bytes instead; see its note).  One field mul is an 8x8 schoolbook of
// 64 wide (32x32->64) products plus 9 for the fold by 2^32 + 977;
// cuda_ec.int_muls() counts, per lane from the ladder shape, what the
// formulas need (squarings at 36 products, muls by 2 and 8 as shifts),
// which is less than these kernels do.  Latency, not throughput, limits
// them at the launches the auctions make: one lane's chain of point ops.
//
// What it leaves on the table: PTX carry chains (mad.lo.cc/madc.hi) in
// place of 64-bit accumulators, and signed-digit windows (8 entries per
// table instead of 16).
#include <cuda_runtime.h>

#include <cstdint>

#include "ec_device.cuh"
#include "ec_group.cuh"

namespace {

using pa::grp::Args;
using pa::grp::kWarp;

// ---------------------------------------------------------------------------
// The group kernels of ec_group.cuh (several threads per lane, tables in
// shared memory):
//  * mul_comb: k*B over a (64, 16, 3, 8)-word comb table of B, 64 complete
//    adds a lane.  Replaces _mul_base_kernel
//    (privacy_auction_tpu/ops/pallas_ec.py:538).
//  * scalar_mul: k*P over `windows` 4-bit windows (64: the ladder without
//    GLV), the Straus ladder with one source.  Replaces _scalar_mul_kernel
//    (privacy_auction_tpu/ops/pallas_ec.py:346).
//  * dual_mul: k1*P1 + k2*P2, at 33 windows for the GLV halves of
//    scalar_mul, and at 64 windows on full scalars (kp*P + kq*Q without
//    GLV).  Replaces _dual_mul_kernel (privacy_auction_tpu/ops/pallas_ec.py:366)
//    at both window counts.
//  * quad_mul: sum of four k_i*P_i over GLV half-scalars.  Replaces
//    _quad_mul_kernel (privacy_auction_tpu/ops/pallas_ec.py:404).
//  * base_mul_add: g^s * P^t without GLV over the 64 windows of the full
//    scalars: per window, in the TPU kernel's order, 4 doublings, the add of
//    s_w*G from the constant window-0 table of G (affine, Z = 1; every lane
//    the same entries, which replaces the TPU's exact one-hot f32 MXU
//    matmuls), then the add of t_w*P.  Replaces _base_mul_add_kernel
//    (privacy_auction_tpu/ops/pallas_ec.py:496).
//  * base_mul_add_glv: g^s * P^t with both scalars GLV-split.  Replaces
//    _base_mul_add_glv_kernel (privacy_auction_tpu/ops/pallas_ec.py:436).
//    P1/P2 are the sign-adjusted +-P / +-phi(P) with magnitudes t1/t2;
//    s1/s2 the magnitudes of s's halves with signs in sflags (n, 2).  The
//    generator side reads the constant window-0 tables of G and phi(G)
//    (affine, Z = 1) and negates the fetched Y where the lane's sign flag is
//    set: any (0:y:0) is a valid infinity for the complete formulas.
// Threads a lane, G = 8 or 4 (mul_comb: 8 or 2), chosen by the wrapper from
// the launch's lanes, per kernel (cuda_ec.launch_shape): a small launch is a
// few warps an SM and latency-bound, and 8 threads take an add in two rounds
// of muls, not four or six; a large one keeps the card busy with fewer
// threads, which do less work in all (measured on the H100: PERF.md,
// Findings).
// ---------------------------------------------------------------------------
template <int G>
__global__ void __launch_bounds__(pa::grp::kCombMaxThreads)
mul_comb_kernel(pa::grp::CombArgs a) {
  pa::grp::comb_group<G>(a);
}

template <int G>
__global__ void __launch_bounds__(kWarp) scalar_mul_kernel(Args a) {
  pa::grp::straus_group<1, 0, false, G>(a);
}

template <int G>
__global__ void __launch_bounds__(kWarp) dual_mul_kernel(Args a) {
  pa::grp::straus_group<2, 0, false, G>(a);
}

template <int G>
__global__ void __launch_bounds__(kWarp) quad_mul_kernel(Args a) {
  pa::grp::straus_group<4, 0, false, G>(a);
}

template <int G>
__global__ void __launch_bounds__(kWarp) base_mul_add_kernel(Args a) {
  pa::grp::straus_group<2, 1, false, G>(a);
}

template <int G>
__global__ void __launch_bounds__(kWarp) base_mul_add_glv_kernel(Args a) {
  pa::grp::straus_group<4, 2, true, G>(a);
}

template <class A>
int launch(void (*kernel)(A), const A& a, int blocks, int threads, int smem,
           void* stream) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

enum Ladder { kScalar, kDual, kQuad, kBase, kGlv };
constexpr int kSources[] = {1, 2, 4, 2, 4};       // lookups a window
constexpr int kConstTables[] = {0, 0, 0, 1, 2};   // of them constant tables

// Launch a Straus group kernel with the shape the wrapper computed
// (cuda_ec.launch_shape); a shape that differs from this build's is refused.
template <Ladder L, int G>
int launch_straus(const Args& a, int blocks, int threads, int smem, void* stream) {
  using S = pa::grp::Shape<G>;
  if (blocks != S::blocks(a.n) || threads != kWarp ||
      smem != S::smem(kSources[L], kConstTables[L]))
    return (int)cudaErrorInvalidValue;
  if constexpr (L == kScalar)
    return launch(scalar_mul_kernel<G>, a, blocks, threads, smem, stream);
  else if constexpr (L == kDual)
    return launch(dual_mul_kernel<G>, a, blocks, threads, smem, stream);
  else if constexpr (L == kQuad)
    return launch(quad_mul_kernel<G>, a, blocks, threads, smem, stream);
  else if constexpr (L == kBase)
    return launch(base_mul_add_kernel<G>, a, blocks, threads, smem, stream);
  else
    return launch(base_mul_add_glv_kernel<G>, a, blocks, threads, smem, stream);
}

template <Ladder L>
int launch_straus(const Args& a, int group, int blocks, int threads, int smem,
                  void* stream) {
  if (a.n <= 0) return (int)cudaGetLastError();
  if (group == 8) return launch_straus<L, 8>(a, blocks, threads, smem, stream);
  if (group == 4) return launch_straus<L, 4>(a, blocks, threads, smem, stream);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// pt_add: one complete RCB16 Alg 7 add P + Q a lane, the sequence of the
// plain ec.add.  Replaces _pt_add_kernel (privacy_auction_tpu/ops/pallas_ec.py:399).
// Bound by bytes, not multiplies: a lane moves 1,152 B as int64 limbs (two
// 384 B points read, one written) for 12 field muls.  Below some ten
// thousand lanes a launch is too small to stream those bytes at the card's
// rate, and one lane's chain of muls sets its time.  So a lane is G threads
// of one warp sharing the add by field multiply (pt_add_grp<G>, two rounds
// of six muls at G = 8), one warp a block of 32 / G lanes, which spreads a
// launch over G times as many warps as one thread a lane would; and the
// block's points come in and go out through shared memory as 16-byte chunks
// at consecutive addresses (a chunk is two limbs, one 32-bit word,
// converted once), not as each thread's own 48 limbs at a 384 B stride.
// ---------------------------------------------------------------------------
template <int G>
__global__ void __launch_bounds__(kWarp)
pt_add_kernel(const longlong2* __restrict__ P, const longlong2* __restrict__ Q,
              longlong2* __restrict__ out, int n) {
  constexpr int kLanes = kWarp / G;
  constexpr int kWords = 24;            // 32-bit words of a point
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* sp = reinterpret_cast<uint32_t*>(smem);   // P, then the sums
  uint32_t* sq = sp + kLanes * kWords;                 // Q
  const int first = blockIdx.x * kLanes;
  const int words = min(kLanes, n - first) * kWords;   // the ragged edge
  const size_t base = (size_t)first * kWords;
  for (int j = threadIdx.x; j < words; j += kWarp) {
    const longlong2 p = P[base + j], q = Q[base + j];
    sp[j] = (uint32_t)p.x | ((uint32_t)p.y << 16);
    sq[j] = (uint32_t)q.x | ((uint32_t)q.y << 16);
  }
  __syncthreads();
  // a lane past the edge adds the block's first lane again and stores
  // nothing: every thread of the warp takes part in the shuffles
  const int g = threadIdx.x % G;
  const int slot = first + threadIdx.x / G < n ? threadIdx.x / G : 0;
  const pa::Pt a = *reinterpret_cast<const pa::Pt*>(sp + slot * kWords);
  const pa::Pt b = *reinterpret_cast<const pa::Pt*>(sq + slot * kWords);
  const pa::Pt r = pa::grp::pt_add_grp<G>(a, b, g);
  __syncthreads();
  if (slot == threadIdx.x / G) {
    // thread g stores words g, g + G, ...: indices fixed at compile time,
    // so r stays in registers
    const uint32_t* rw = reinterpret_cast<const uint32_t*>(&r);
#pragma unroll
    for (int i = 0; i < kWords; ++i)
      if (i % G == g) sp[slot * kWords + i] = rw[i];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < words; j += kWarp)
    out[base + j] = make_longlong2(sp[j] & 0xffffu, sp[j] >> 16);
}

template <int G>
int launch_pt_add(const int64_t* P, const int64_t* Q, int64_t* out, int n,
                  int blocks, int threads, int smem, void* stream) {
  constexpr int kLanes = kWarp / G;
  if (blocks != (n + kLanes - 1) / kLanes || threads != kWarp ||
      smem != 2 * kLanes * 96)
    return (int)cudaErrorInvalidValue;
  pt_add_kernel<G><<<blocks, threads, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const longlong2*>(P), reinterpret_cast<const longlong2*>(Q),
      reinterpret_cast<longlong2*>(out), n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The comb's shape: G = 8 or 2 threads a lane, a block of whole warps (at most
// kCombMaxThreads), blocks that cover the lanes with at most one ragged, and
// shared memory for a ring of 2..64 window tables; anything else is refused.
int pa_mul_comb(const int64_t* k, const uint32_t* table, int64_t* out, int n,
                int group, int blocks, int threads, int smem, void* stream) {
  using pa::grp::kTableBytes;
  if (n <= 0) return (int)cudaGetLastError();
  const pa::grp::CombArgs a{k, table, out, n, smem / kTableBytes};
  if ((group != 8 && group != 2) || threads % pa::grp::kWarp != 0 ||
      threads <= 0 ||
      threads > pa::grp::kCombMaxThreads || smem % kTableBytes != 0 || a.ring < 2 ||
      a.ring > pa::grp::kCombWindows || blocks != (n + threads / group - 1) / (threads / group))
    return (int)cudaErrorInvalidValue;
  if (group == 8) return launch(mul_comb_kernel<8>, a, blocks, threads, smem, stream);
  return launch(mul_comb_kernel<2>, a, blocks, threads, smem, stream);
}

int pa_scalar_mul(const int64_t* P, const int64_t* k, int64_t* out, int n,
                  int windows, int group, int blocks, int threads, int smem,
                  void* stream) {
  Args a{{P, nullptr, nullptr, nullptr}, {k, nullptr, nullptr, nullptr}, nullptr,
         nullptr, out, n, windows};
  return launch_straus<kScalar>(a, group, blocks, threads, smem, stream);
}

int pa_dual_mul(const int64_t* P1, const int64_t* k1, const int64_t* P2,
                const int64_t* k2, int64_t* out, int n, int windows, int group,
                int blocks, int threads, int smem, void* stream) {
  Args a{{P1, P2, nullptr, nullptr}, {k1, k2, nullptr, nullptr}, nullptr,
         nullptr, out, n, windows};
  return launch_straus<kDual>(a, group, blocks, threads, smem, stream);
}

int pa_quad_mul(const int64_t* P1, const int64_t* k1, const int64_t* P2,
                const int64_t* k2, const int64_t* P3, const int64_t* k3,
                const int64_t* P4, const int64_t* k4, int64_t* out, int n,
                int windows, int group, int blocks, int threads, int smem,
                void* stream) {
  Args a{{P1, P2, P3, P4}, {k1, k2, k3, k4}, nullptr, nullptr, out, n, windows};
  return launch_straus<kQuad>(a, group, blocks, threads, smem, stream);
}

int pa_base_mul_add_glv(const int64_t* P1, const int64_t* t1, const int64_t* P2,
                        const int64_t* t2, const int64_t* s1, const int64_t* s2,
                        const int64_t* sflags, const uint32_t* g0, int64_t* out,
                        int n, int windows, int group, int blocks, int threads,
                        int smem, void* stream) {
  Args a{{nullptr, nullptr, P1, P2}, {s1, s2, t1, t2}, sflags, g0, out, n, windows};
  return launch_straus<kGlv>(a, group, blocks, threads, smem, stream);
}

int pa_base_mul_add(const int64_t* P, const int64_t* t, const int64_t* s,
                    const uint32_t* g0, int64_t* out, int n, int group, int blocks,
                    int threads, int smem, void* stream) {
  Args a{{nullptr, P, nullptr, nullptr}, {s, t, nullptr, nullptr}, nullptr, g0, out, n,
         pa::grp::kCombWindows};
  return launch_straus<kBase>(a, group, blocks, threads, smem, stream);
}

// pt_add's shape: G = 8 or 4 threads a lane, one warp of 32 / G lanes a
// block, shared memory for the block's P and Q as 32-bit words; the points'
// addresses 16-byte aligned (the wrapper checks); anything else is refused.
int pa_pt_add(const int64_t* P, const int64_t* Q, int64_t* out, int n, int group,
              int blocks, int threads, int smem, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (group == 8) return launch_pt_add<8>(P, Q, out, n, blocks, threads, smem, stream);
  if (group == 4) return launch_pt_add<4>(P, Q, out, n, blocks, threads, smem, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
