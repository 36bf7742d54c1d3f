// Ladders with several threads per lane, window tables in shared memory:
// the Hopper design of every table-lookup kernel of the port (mul_comb,
// scalar_mul, dual_mul, quad_mul, base_mul_add, base_mul_add_glv).
//
// Replaces _mul_base_kernel (privacy_auction_tpu/ops/pallas_ec.py:538),
// _scalar_mul_kernel (privacy_auction_tpu/ops/pallas_ec.py:346),
// _dual_mul_kernel (privacy_auction_tpu/ops/pallas_ec.py:366), at 33 and 64
// windows, _quad_mul_kernel (privacy_auction_tpu/ops/pallas_ec.py:404),
// _base_mul_add_kernel (privacy_auction_tpu/ops/pallas_ec.py:496) and
// _base_mul_add_glv_kernel (privacy_auction_tpu/ops/pallas_ec.py:436).
//
// What bounds them on this card.  The auctions give these kernels a few
// hundred to twenty thousand lanes a launch: with one thread per lane that
// is 2-160 blocks of 128 threads on 132 SMs, and each lane is one long
// dependent chain (quad_mul: 56 table adds, then 33 x (4 doublings + 4
// adds); mul_comb: 64 adds) with its tables in local or device memory.  The
// 32-bit multiplies themselves would take the card 0.005-0.3 ms (PERF.md):
// latency, not throughput, sets the time.
//
// What the design does about it:
//  * a lane is a group of G consecutive threads (G = 8 or 4, or 8 or 2 for
//    mul_comb, set per kernel from the launch's lanes by
//    cuda_ec.launch_shape).  In the Straus ladders thread g serves lookup
//    source g % S (S = 1 for scalar_mul: P; S = 2 for dual_mul: P1, P2, and
//    for base_mul_add: G, P; S = 4 for quad_mul: P1..P4, and for
//    base_mul_add_glv: G, phi(G), +-P, +-phi(P), the order of the plain
//    version): it makes that lookup each window (the S selects run side by
//    side; with S = 1 all G threads make the one select, as broadcasts);
//  * the constant sources (G; G and phi(G)) are window-0 tables held once a
//    block.  A lane with several tables of its own builds each on the
//    thread that serves it (the builds run side by side, one thread's 14
//    adds each); a lane with one (scalar_mul, base_mul_add) builds it with
//    the group add, all G threads sharing each of the 14 adds;
//  * the accumulator is held by all G threads; each point operation on it is
//    shared out by field multiply: RCB16 Alg 7 is two rounds of six
//    independent muls (one pass each with 8 threads, two with 4, three with
//    2), Alg 9 two rounds of four.  Products and selected entries travel by
//    warp shuffles of width G.  SIMT runs the threads' muls as one warp
//    instruction stream, so a Straus lane's chain is 16 (G = 8) or 24
//    (G = 4) mul passes a window of four adds, not 80 muls.  The products
//    are the shorter-latency fe_mul_fast and fe_mul_small_fast of
//    ec_device.cuh;
//  * window tables live in shared memory as 16-byte chunks, one (entry,
//    chunk) of all the warp's tables side by side: a select reads all 16
//    entries with conflict-free 128-bit loads at addresses that depend on
//    the public entry index only, and masks by the secret digit with
//    inline-PTX AND;
//  * the Straus ladders run one warp a block: 4 or 8 lanes, so 160 lanes
//    spread over 40 SMs.  A block takes 6 or 12 KiB of shared memory for
//    scalar_mul, 12 or 24 KiB for dual_mul, 24 or 48 KiB for quad_mul, 7.5
//    or 13.5 KiB for base_mul_add, 15 or 27 KiB for base_mul_add_glv;
//  * mul_comb's comb table is the same for every lane, so its selects are
//    broadcasts from one copy a block: a ring of `ring` window tables
//    (1,536 B each; 64 holds the whole table), filled by cp.async ahead of
//    the window that reads it, under one __syncthreads a window.  Every
//    thread of a lane makes the lane's select, so no entry is shuffled.
//    mul_comb runs G = 8 or 2 threads a lane: its large launches (8,192
//    lanes and up) keep every scheduler busy, and there the G threads of a
//    lane, which repeat an add's adds, subs and select, cost more than the
//    shorter chain saves; 2 threads take an add in six mul passes, not 12.
//    Its block is sized to the launch (cuda_ec.comb_shape): one block an
//    SM where 4 to 12 warps can hold the lanes, so each of the SM's four
//    schedulers gets the same number of warps (measured on the H100:
//    PERF.md).
//
// The order of point operations on the accumulator is the plain version's
// and every field op returns the canonical value, so the output equals
// ec.mul_comb_plain / ec.scalar_mul_windows_plain / ec.dual_mul_windows_plain
// / ec.quad_mul_windows_plain / ec.base_mul_add_plain /
// ec.base_mul_add_glv_plain limb for limb.
#pragma once

#include <cstdint>

#include "ec_device.cuh"

namespace pa {
namespace grp {

constexpr int kMaxSources = 4;                   // lookups a window, at most
constexpr int kWarp = 32;                        // threads a Straus block
constexpr int kChunks = 6;                       // 16-byte chunks of a point
constexpr int kTableBytes = 16 * kChunks * 16;   // 16 entries of 96 B
constexpr int kCombWindows = 64;                 // window tables of a comb
constexpr int kCombMaxThreads = 384;             // threads a mul_comb block

// G threads a lane, one warp of kWarp / G lanes a block.  A Straus ladder
// over S sources, the first C of them constant, holds the C constant tables
// once, then the S - C tables of each lane.
template <int G>
struct Shape {
  static constexpr int kLanes = kWarp / G;
  static constexpr int smem(int S, int C) { return (C + (S - C) * kLanes) * kTableBytes; }
  static int blocks(int n) { return (n + kLanes - 1) / kLanes; }
};

// Source i's point (unused for a constant source) and scalar.
struct Args {
  const int64_t* P[kMaxSources];   // scalar: P; dual: P1, P2; quad: P1..P4;
                                   // base: unused, P; glv: unused, unused, P1, P2
  const int64_t* k[kMaxSources];   // scalar: k; dual: k1, k2; quad: k1..k4;
                                   // base: s, t; glv: s1, s2, t1, t2
  const int64_t* sflags;        // glv: (n, 2) sign flags of s1, s2
  const uint32_t* g0;           // base: (16, 3, 8) words of d*G; glv:
                                // (2, 16, 3, 8) words of d*G, d*phi(G)
  int64_t* out;
  int n;
  int windows;
};

// --- exchange within a lane's group ---------------------------------------

template <int G>
__device__ __forceinline__ Fe fe_shfl(const Fe& a, int src) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = __shfl_sync(0xffffffffu, a.w[i], src, G);
  return r;
}

template <int G>
__device__ __forceinline__ Fe fe_shfl_xor(const Fe& a, int mask) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = __shfl_xor_sync(0xffffffffu, a.w[i], mask, G);
  return r;
}

template <int G>
__device__ __forceinline__ Pt pt_shfl(const Pt& P, int src) {
  Pt r;
  r.x = fe_shfl<G>(P.x, src);
  r.y = fe_shfl<G>(P.y, src);
  r.z = fe_shfl<G>(P.z, src);
  return r;
}

__device__ __forceinline__ uint32_t pick_word(int g, int i, const Fe& a) { return a.w[i]; }

template <class... R>
__device__ __forceinline__ uint32_t pick_word(int g, int i, const Fe& a, const R&... rest) {
  return g == 0 ? a.w[i] : pick_word(g - 1, i, rest...);
}

// The operand of thread g (a public index): the g-th of the list, the last
// one for the threads past its end.
template <class... R>
__device__ __forceinline__ Fe fe_pick(int g, const R&... ops) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = pick_word(g, i, ops...);
  return r;
}

// --- point operations shared by the G threads of a lane -------------------
// P and Q are the same in all G threads, and so is the result.  The field
// values are those of pt_add / pt_dbl, the products from the shorter-latency
// fe_mul_fast and fe_mul_small_fast.

// Complete addition, RCB16 Algorithm 7 (a = 0): two rounds of six muls,
// one pass each with 8 threads, two with 4, three with 2.
template <int G>
__device__ __forceinline__ Pt pt_add_grp(const Pt& P, const Pt& Q, int g) {
  const Fe z = fe_zero();
  Fe t0, t1, t2, u1, u2, u3;
  if constexpr (G == 8) {
    // t0 = X1X2, t1 = Y1Y2, t2 = Z1Z2, u1 = (X1+Y1)(X2+Y2),
    // u2 = (Y1+Z1)(Y2+Z2), u3 = (X1+Z1)(X2+Z2) on threads 0-5
    const Fe m = fe_mul_fast(
        fe_add(fe_pick(g, P.x, P.y, P.z, P.x, P.y, P.x), fe_pick(g, z, z, z, P.y, P.z, P.z)),
        fe_add(fe_pick(g, Q.x, Q.y, Q.z, Q.x, Q.y, Q.x), fe_pick(g, z, z, z, Q.y, Q.z, Q.z)));
    t0 = fe_shfl<G>(m, 0), t1 = fe_shfl<G>(m, 1), t2 = fe_shfl<G>(m, 2);
    u1 = fe_shfl<G>(m, 3), u2 = fe_shfl<G>(m, 4), u3 = fe_shfl<G>(m, 5);
  } else if constexpr (G == 4) {
    // t0, t1, t2, u1 on threads 0-3, then u2, u3 on threads 0, 1
    const Fe m1 = fe_mul_fast(
        fe_add(fe_pick(g, P.x, P.y, P.z, P.x), fe_pick(g, z, z, z, P.y)),
        fe_add(fe_pick(g, Q.x, Q.y, Q.z, Q.x), fe_pick(g, z, z, z, Q.y)));
    const Fe m2 = fe_mul_fast(fe_add(fe_pick(g, P.y, P.x), P.z),
                              fe_add(fe_pick(g, Q.y, Q.x), Q.z));
    t0 = fe_shfl<G>(m1, 0), t1 = fe_shfl<G>(m1, 1), t2 = fe_shfl<G>(m1, 2);
    u1 = fe_shfl<G>(m1, 3), u2 = fe_shfl<G>(m2, 0), u3 = fe_shfl<G>(m2, 1);
  } else {
    static_assert(G == 2, "8, 4 or 2 threads a lane");
    // t0, t2, u2 on thread 0 and t1, u1, u3 on thread 1, one a pass
    const Fe ma = fe_mul_fast(fe_pick(g, P.x, P.y), fe_pick(g, Q.x, Q.y));
    const Fe mb = fe_mul_fast(fe_add(fe_pick(g, P.z, P.x), fe_pick(g, z, P.y)),
                              fe_add(fe_pick(g, Q.z, Q.x), fe_pick(g, z, Q.y)));
    const Fe mc = fe_mul_fast(fe_add(fe_pick(g, P.y, P.x), P.z),
                              fe_add(fe_pick(g, Q.y, Q.x), Q.z));
    t0 = fe_shfl<G>(ma, 0), t1 = fe_shfl<G>(ma, 1), t2 = fe_shfl<G>(mb, 0);
    u1 = fe_shfl<G>(mb, 1), u2 = fe_shfl<G>(mc, 0), u3 = fe_shfl<G>(mc, 1);
  }
  const Fe t3 = fe_sub(u1, fe_add(t0, t1));   // X1Y2 + X2Y1
  const Fe t4 = fe_sub(u2, fe_add(t1, t2));   // Y1Z2 + Y2Z1
  const Fe y3 = fe_sub(u3, fe_add(t0, t2));   // X1Z2 + X2Z1
  const Fe t0_3 = fe_mul_small_fast(t0, 3u);
  const Fe t2b = fe_mul_small_fast(t2, kB3);
  const Fe y3b = fe_mul_small_fast(y3, kB3);
  const Fe z3p = fe_add(t1, t2b);
  const Fe t1m = fe_sub(t1, t2b);
  // X3 = t3 t1m - t4 y3b, Y3 = t1m z3p + y3b t0_3, Z3 = z3p t4 + t0_3 t3
  Pt R;
  if constexpr (G == 8) {
    // the six products on threads 0-5, each pair summed on its even thread
    const Fe p = fe_mul_fast(fe_pick(g, t3, t4, t1m, y3b, z3p, t0_3),
                             fe_pick(g, t1m, y3b, z3p, t0_3, t4, t3));
    const Fe q = fe_shfl_xor<G>(p, 1);
    const Fe o = fe_select(0u - (uint32_t)(g == 0), fe_sub(p, q), fe_add(p, q));
    R.x = fe_shfl<G>(o, 0);
    R.y = fe_shfl<G>(o, 2);
    R.z = fe_shfl<G>(o, 4);
  } else if constexpr (G == 4) {
    // one coordinate a thread (0-2), two products each
    const Fe p = fe_mul_fast(fe_pick(g, t3, t1m, z3p), fe_pick(g, t1m, z3p, t4));
    const Fe q = fe_mul_fast(fe_pick(g, t4, y3b, t0_3), fe_pick(g, y3b, t0_3, t3));
    const Fe o = fe_select(0u - (uint32_t)(g == 0), fe_sub(p, q), fe_add(p, q));
    R.x = fe_shfl<G>(o, 0);
    R.y = fe_shfl<G>(o, 1);
    R.z = fe_shfl<G>(o, 2);
  } else {
    // X3 on thread 0 and Y3 on thread 1, two products each; Z3 from one
    // product of each
    const Fe pa = fe_mul_fast(fe_pick(g, t3, t1m), fe_pick(g, t1m, z3p));
    const Fe pb = fe_mul_fast(fe_pick(g, t4, y3b), fe_pick(g, y3b, t0_3));
    const Fe pc = fe_mul_fast(fe_pick(g, z3p, t0_3), fe_pick(g, t4, t3));
    const Fe o = fe_select(0u - (uint32_t)(g == 0), fe_sub(pa, pb), fe_add(pa, pb));
    R.x = fe_shfl<G>(o, 0);
    R.y = fe_shfl<G>(o, 1);
    R.z = fe_add(fe_shfl<G>(pc, 0), fe_shfl<G>(pc, 1));
  }
  return R;
}

// Complete doubling, RCB16 Algorithm 9 (a = 0): two rounds of four muls,
// one pass each (threads 0-3).
template <int G>
__device__ __forceinline__ Pt pt_dbl_grp(const Pt& P, int g) {
  // t0 = Y^2, t1 = YZ, t2 = Z^2, xy = XY
  const Fe m = fe_mul_fast(fe_pick(g, P.y, P.y, P.z, P.x), fe_pick(g, P.y, P.z, P.z, P.y));
  const Fe t0 = fe_shfl<G>(m, 0), t1 = fe_shfl<G>(m, 1), t2 = fe_shfl<G>(m, 2);
  const Fe xy = fe_shfl<G>(m, 3);
  const Fe z3a = fe_mul_small_fast(t0, 8u);
  const Fe t2b = fe_mul_small_fast(t2, kB3);
  const Fe t2c = fe_mul_small_fast(t2, 3u * kB3);
  const Fe y3a = fe_add(t0, t2b);
  const Fe t0m = fe_sub(t0, t2c);
  // X3 = 2 t0m xy, Y3 = t2b z3a + t0m y3a, Z3 = t1 z3a
  const Fe p = fe_mul_fast(fe_pick(g, t0m, t2b, t0m, t1), fe_pick(g, xy, z3a, y3a, z3a));
  const Fe o = fe_select(0u - (uint32_t)(g == 0), fe_add(p, p), p);
  Pt R;
  R.x = fe_shfl<G>(o, 0);
  R.y = fe_add(fe_shfl<G>(o, 1), fe_shfl<G>(o, 2));
  R.z = fe_shfl<G>(o, 3);
  return R;
}

// --- window tables in shared memory ---------------------------------------
// Chunk i (16 B) of entry e of a thread's table is at shared byte address
// base + (6e + i) * stride.

// Entry e = P, the chunks i with i % step == first (all by default: thread
// g of a lane's G stores chunks g, g + G with first = g, step = G).
__device__ __forceinline__ void st_entry(uint32_t base, uint32_t stride, uint32_t e,
                                         const Pt& P, int first = 0, int step = 1) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&P);
#pragma unroll
  for (int i = 0; i < kChunks; ++i)
    if (i % step == first)
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};"
                   :: "r"(base + (kChunks * e + i) * stride), "r"(w[4 * i]),
                      "r"(w[4 * i + 1]), "r"(w[4 * i + 2]), "r"(w[4 * i + 3])
                   : "memory");
}

// Constant-time entry d: all 96 chunks are loaded (addresses from the
// public entry index) and masked in by the digit with inline PTX.
// chip_smoke.py finds this function in the SASS and checks that it loads
// all 16 entries and that no load is predicated.
__device__ __noinline__ Pt pt_select16_shared(uint32_t base, uint32_t stride, uint32_t d) {
  uint32_t r[24];
#pragma unroll
  for (int k = 0; k < 24; ++k) r[k] = 0u;
#pragma unroll
  for (uint32_t e = 0; e < 16; ++e) {
    const uint32_t m = digit_mask(d, e);
#pragma unroll
    for (int i = 0; i < kChunks; ++i)
      asm volatile(
          "{\n\t.reg .b32 w0, w1, w2, w3;\n\t"
          "ld.shared.v4.b32 {w0, w1, w2, w3}, [%4];\n\t"
          "and.b32 w0, w0, %5;\n\tand.b32 w1, w1, %5;\n\t"
          "and.b32 w2, w2, %5;\n\tand.b32 w3, w3, %5;\n\t"
          "or.b32 %0, %0, w0;\n\tor.b32 %1, %1, w1;\n\t"
          "or.b32 %2, %2, w2;\n\tor.b32 %3, %3, w3;\n\t}"
          : "+r"(r[4 * i]), "+r"(r[4 * i + 1]), "+r"(r[4 * i + 2]), "+r"(r[4 * i + 3])
          : "r"(base + (kChunks * e + i) * stride), "r"(m));
  }
  Pt out;
  uint32_t* ow = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int k = 0; k < 24; ++k) ow[k] = r[k];
  return out;
}

// [inf, P, 2P, ..., 15P] into the thread's table, entry i+1 = add(entry i, P)
// as _fill_table (each thread its own table, one thread's adds with the
// shorter-latency products).
__device__ __noinline__ void fill_table_shared(uint32_t base, uint32_t stride, const Pt& P) {
  st_entry(base, stride, 0, pt_infinity());
  st_entry(base, stride, 1, P);
  Pt T = P;
#pragma unroll 1
  for (uint32_t e = 2; e < 16; ++e) {
    T = pt_add_t<FieldFast>(T, P);
    st_entry(base, stride, e, T);
  }
}

// The same table of the lane by its G threads: each add shared by the group
// (pt_add_grp, the same canonical values), thread g storing chunks g, g + G
// of each entry.
template <int G>
__device__ __forceinline__ void fill_table_grp(uint32_t base, uint32_t stride, const Pt& P,
                                               int g) {
  st_entry(base, stride, 0, pt_infinity(), g, G);
  st_entry(base, stride, 1, P, g, G);
  Pt T = P;
#pragma unroll 1
  for (uint32_t e = 2; e < 16; ++e) {
    T = pt_add_grp<G>(T, P, g);
    st_entry(base, stride, e, T, g, G);
  }
}

// fill_table_grp as a call of its own.  Measured on the H100 (PERF.md),
// scalar_mul and base_mul_add ran 18-22% faster with the call at G = 8
// (8-2,048 lanes) and 9-13% slower at G = 4 (8,192 lanes) than with the
// build inlined, which ptxas compiles with other register counts.
template <int G>
__device__ __noinline__ void fill_table_grp_call(uint32_t base, uint32_t stride, const Pt& P,
                                                 int g) {
  fill_table_grp<G>(base, stride, P, g);
}

// The Straus ladder over S sources, the first C of them constant window-0
// tables held once a block (base_mul_add: G; base_mul_add_glv: G and
// phi(G), the fetched Y negated where the lane's sign flag is set, kSigned),
// the others a table of each lane: per window, most significant first, 4
// doublings, then the add of lookup 0, ..., S-1 in that order.  Thread g of
// a lane serves source g % S (threads S..G-1 repeat the lookups of
// 0..S-1: the same addresses, read as broadcasts).
template <int S, int C, bool kSigned, int G>
__device__ __forceinline__ void straus_group(const Args& a) {
  static_assert(S == 1 || S == 2 || S == 4, "scalar_mul, dual_mul, quad_mul");
  static_assert(C < S && (!kSigned || C > 0), "a lane has a table of its own");
  constexpr int L = S - C;   // tables of each lane
  constexpr bool kGroupFill = L == 1;
  using Sh = Shape<G>;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem);
  const int tid = threadIdx.x;
  const int g = tid % G;
  const int src = g % S;
  const int slot = tid / G;
  const int want = blockIdx.x * Sh::kLanes + slot;
  // the ragged edge repeats the last lane and stores nothing: every thread
  // of the warp takes part in the shuffles
  const int lane = want < a.n ? want : a.n - 1;
  const int64_t* Ps = src == 0 ? a.P[0] : src == 1 ? a.P[1] : src == 2 ? a.P[2] : a.P[3];
  const int64_t* kl =
      (src == 0 ? a.k[0] : src == 1 ? a.k[1] : src == 2 ? a.k[2] : a.k[3]) + (size_t)lane * 16;
  // constant tables: chunk i of entry e of table s at ((6e + i) * C + s) * 16;
  // the lane's table j after them, at ((6e + i) * L * kLanes + L * slot + j) * 16
  const uint32_t lbase = sbase + C * kTableBytes + 16u * L * slot;
  const uint32_t lstride = 16u * L * Sh::kLanes;
  uint32_t base, stride;
  uint32_t neg = 0u;
  if constexpr (C > 0) {
    uint32_t* cw = reinterpret_cast<uint32_t*>(smem);
    for (int idx = tid; idx < C * 16 * 24; idx += kWarp) {
      const int s = idx / (16 * 24), e = idx / 24 % 16, k = idx % 24;
      cw[((kChunks * e + k / 4) * C + s) * 4 + k % 4] = a.g0[idx];
    }
  }
  // C = 0 spelled out: so written, ptxas compiles dual_mul and quad_mul
  // to the registers and times they had before the constant sources
  // (measured on the H100, PERF.md)
  if constexpr (C == 0) {
    base = sbase + 16u * (S * slot + src);
    stride = 16u * S * Sh::kLanes;
  } else if (src < C) {
    base = sbase + 16u * src;
    stride = 16u * C;
    if (kSigned) neg = 0u - (uint32_t)(a.sflags[(size_t)lane * C + src] != 0);
  } else {
    base = lbase + 16u * (src - C);
    stride = lstride;
  }
  if constexpr (kGroupFill && G == 8)
    fill_table_grp_call<G>(lbase, lstride, pt_load_limbs(a.P[C] + (size_t)lane * 48), g);
  else if constexpr (kGroupFill)
    fill_table_grp<G>(lbase, lstride, pt_load_limbs(a.P[C] + (size_t)lane * 48), g);
  else if (g < S && (C == 0 || src >= C))
    fill_table_shared(base, stride, pt_load_limbs(Ps + (size_t)lane * 48));
  __syncthreads();
  Pt acc = pt_infinity();
#pragma unroll 1
  for (int w = a.windows - 1; w >= 0; --w) {
#pragma unroll 1
    for (int i = 0; i < 4; ++i) acc = pt_dbl_grp<G>(acc, g);
    Pt e = pt_select16_shared(base, stride, scalar_digit(kl, w));
    if (kSigned) e.y = fe_select(neg, fe_neg(e.y), e.y);
    if constexpr (S == 1) {
      acc = pt_add_grp<G>(acc, e, g);   // every thread made the one lookup
    } else {
#pragma unroll 1
      for (int s = 0; s < S; ++s) acc = pt_add_grp<G>(acc, pt_shfl<G>(e, s), g);
    }
  }
  if (want < a.n && g == 0) pt_store_limbs(a.out + (size_t)lane * 48, acc);
}

// --- the comb: k*B over a constant (64, 16, 3, 8)-word table --------------

struct CombArgs {
  const int64_t* k;
  const uint32_t* table;   // window w, entry e at word (16 w + e) * 24
  int64_t* out;
  int n;
  int ring;                // window tables resident a block, 2..64
};

// 16 bytes from device to shared memory, asynchronously (Ampere's
// cp.async; both addresses 16-byte aligned).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" :: "r"(dst), "l"(src)
               : "memory");
}

// Window table w of the comb into ring slot `slot`, by all threads of the
// block, as one cp.async group.
__device__ __forceinline__ void comb_fetch(uint32_t sbase, const uint32_t* table,
                                           int w, int slot) {
  const unsigned char* src = reinterpret_cast<const unsigned char*>(table) +
                             (size_t)w * kTableBytes;
  for (int c = threadIdx.x; c < kTableBytes / 16; c += blockDim.x)
    cp_async16(sbase + slot * kTableBytes + 16u * c, src + 16 * c);
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Windows 0..63 in ascending order from the point at infinity, one complete
// add a window (the first, from infinity, included: it fixes the output's
// projective limbs), as _mul_base_kernel and ec.mul_comb_plain.  The block
// of blockDim.x / G lanes holds `ring` window tables: window w + ring - 1 is
// fetched into the slot of window w - 1 once every thread has passed that
// window's select (the barrier of window w), and has until the barrier of
// window w + 1, one add later, to land.  The barriers depend on no digit.
template <int G>
__device__ __forceinline__ void comb_group(const CombArgs& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem);
  const int g = threadIdx.x % G;
  const int want = blockIdx.x * (blockDim.x / G) + threadIdx.x / G;
  // the ragged edge repeats the last lane and stores nothing: every thread
  // of the block takes part in the shuffles and the barriers
  const int lane = want < a.n ? want : a.n - 1;
  const int64_t* kl = a.k + (size_t)lane * 16;
  for (int w = 0; w < a.ring; ++w) comb_fetch(sbase, a.table, w, w);
  Pt acc = pt_infinity();
#pragma unroll 1
  for (int w = 0; w < kCombWindows; ++w) {
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    if (w > 0 && w - 1 + a.ring < kCombWindows)
      comb_fetch(sbase, a.table, w - 1 + a.ring, (w - 1) % a.ring);
    const uint32_t base = sbase + (w % a.ring) * kTableBytes;
    acc = pt_add_grp<G>(acc, pt_select16_shared(base, 16u, scalar_digit(kl, w)), g);
  }
  if (want < a.n && g == 0) pt_store_limbs(a.out + (size_t)lane * 48, acc);
}

}  // namespace grp
}  // namespace pa
