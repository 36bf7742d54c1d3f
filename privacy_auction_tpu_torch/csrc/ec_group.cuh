// Straus ladders with several threads per lane, window tables in shared
// memory: the Hopper design of quad_mul and base_mul_add_glv.
//
// Replaces _quad_mul_kernel (privacy_auction_tpu/ops/pallas_ec.py:404) and
// _base_mul_add_glv_kernel (privacy_auction_tpu/ops/pallas_ec.py:436).
//
// What bounds them on this card.  The SEAL proof passes give quad_mul 160
// or 320 lanes a launch; with one thread per lane that is 2-3 blocks on 132
// SMs, and each lane is one long dependent chain (56 table adds, then 33 x
// (4 doublings + 4 adds)) with its 6 KiB of tables in local memory.  The
// 32-bit multiplies themselves would take the card about 0.06 ms at 2048
// lanes (PERF.md): latency, not throughput, sets the time.
//
// What the design does about it:
//  * a lane is a group of G consecutive threads (G = 8 up to 2,048 lanes a
//    launch, else 4; cuda_ec.launch_shape).  Thread g serves lookup source
//    g % 4 (quad_mul: the tables of P1..P4; base_mul_add_glv: G, phi(G),
//    +-P, +-phi(P), the order of the plain version): it builds that table
//    (the four 14-add builds run side by side) and makes that lookup each
//    window (the four selects run side by side);
//  * the accumulator is held by all G threads; each point operation on it is
//    shared out by field multiply: RCB16 Alg 7 is two rounds of six
//    independent muls (one pass each with 8 threads, two with 4), Alg 9 two
//    rounds of four.  Products and selected entries travel by warp shuffles
//    of width G.  SIMT runs the threads' muls as one warp instruction
//    stream, so a lane's chain is 16 (G = 8) or 24 (G = 4) mul passes a
//    window, not 80 muls.  The products are the shorter-latency
//    fe_mul_fast and fe_mul_small_fast of ec_device.cuh;
//  * window tables live in shared memory as 16-byte chunks, one (entry,
//    chunk) of all the warp's tables side by side: a select reads all 16
//    entries with conflict-free 128-bit loads at addresses that depend on
//    the public entry index only, and masks by the secret digit with
//    inline-PTX AND.  base_mul_add_glv keeps the constant window-0 tables
//    of G and phi(G) once per block;
//  * one warp a block: 4 or 8 lanes, so 160 lanes spread over 40 SMs.  A
//    block takes 24 or 48 KiB of shared memory for quad_mul, 15 or 27 KiB
//    for base_mul_add_glv.
//
// The order of point operations on the accumulator is the plain version's
// and every field op returns the canonical value, so the output equals
// ec.quad_mul_windows_plain / ec.base_mul_add_glv_plain limb for limb.
#pragma once

#include <cstdint>

#include "ec_device.cuh"

namespace pa {
namespace grp {

constexpr int kSources = 4;                      // lookups a window
constexpr int kWarp = 32;                        // threads a block
constexpr int kChunks = 6;                       // 16-byte chunks of a point
constexpr int kTableBytes = 16 * kChunks * 16;   // 16 entries of 96 B
constexpr int kConstBytes = 2 * kTableBytes;     // G and phi(G), once a block

// G threads a lane, one warp of kWarp / G lanes a block.  quad_mul: a table
// per source of each lane; base_mul_add_glv: the constant tables, then a
// table per per-lane source (2) of each lane.
template <int G>
struct Shape {
  static constexpr int kLanes = kWarp / G;
  static constexpr int kQuadSmem = kLanes * kSources * kTableBytes;
  static constexpr int kGlvSmem = kConstBytes + kLanes * 2 * kTableBytes;
  static int blocks(int n) { return (n + kLanes - 1) / kLanes; }
};

struct Args {
  const int64_t* P[kSources];   // quad: P1..P4; glv: unused, unused, P1, P2
  const int64_t* k[kSources];   // quad: k1..k4; glv: s1, s2, t1, t2
  const int64_t* sflags;        // glv: (n, 2) sign flags of s1, s2
  const uint32_t* g0;           // glv: (2, 16, 3, 8) words of d*G, d*phi(G)
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
// one pass each with 8 threads, two with 4.
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
  } else {
    // t0, t1, t2, u1 on threads 0-3, then u2, u3 on threads 0, 1
    const Fe m1 = fe_mul_fast(
        fe_add(fe_pick(g, P.x, P.y, P.z, P.x), fe_pick(g, z, z, z, P.y)),
        fe_add(fe_pick(g, Q.x, Q.y, Q.z, Q.x), fe_pick(g, z, z, z, Q.y)));
    const Fe m2 = fe_mul_fast(fe_add(fe_pick(g, P.y, P.x), P.z),
                              fe_add(fe_pick(g, Q.y, Q.x), Q.z));
    t0 = fe_shfl<G>(m1, 0), t1 = fe_shfl<G>(m1, 1), t2 = fe_shfl<G>(m1, 2);
    u1 = fe_shfl<G>(m1, 3), u2 = fe_shfl<G>(m2, 0), u3 = fe_shfl<G>(m2, 1);
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
  } else {
    // one coordinate a thread (0-2), two products each
    const Fe p = fe_mul_fast(fe_pick(g, t3, t1m, z3p), fe_pick(g, t1m, z3p, t4));
    const Fe q = fe_mul_fast(fe_pick(g, t4, y3b, t0_3), fe_pick(g, y3b, t0_3, t3));
    const Fe o = fe_select(0u - (uint32_t)(g == 0), fe_sub(p, q), fe_add(p, q));
    R.x = fe_shfl<G>(o, 0);
    R.y = fe_shfl<G>(o, 1);
    R.z = fe_shfl<G>(o, 2);
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

__device__ __forceinline__ void st_entry(uint32_t base, uint32_t stride, uint32_t e,
                                         const Pt& P) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&P);
#pragma unroll
  for (int i = 0; i < kChunks; ++i)
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

// The ladder: per window, most significant first, 4 doublings, then the add
// of lookup 0, 1, 2, 3 in that order.  Thread g of a lane serves source
// g % 4 (with 8 threads, threads 4-7 repeat the lookups of 0-3: the same
// addresses, read as broadcasts).
template <bool kGlv, int G>
__device__ __forceinline__ void straus_group(const Args& a) {
  using S = Shape<G>;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem);
  const int tid = threadIdx.x;
  const int g = tid % G;
  const int src = g % kSources;
  const int slot = tid / G;
  const int want = blockIdx.x * S::kLanes + slot;
  // the ragged edge repeats the last lane and stores nothing: every thread
  // of the warp takes part in the shuffles
  const int lane = want < a.n ? want : a.n - 1;
  const int64_t* Ps = src == 0 ? a.P[0] : src == 1 ? a.P[1] : src == 2 ? a.P[2] : a.P[3];
  const int64_t* kl =
      (src == 0 ? a.k[0] : src == 1 ? a.k[1] : src == 2 ? a.k[2] : a.k[3]) + (size_t)lane * 16;
  uint32_t base, stride;
  uint32_t neg = 0u;
  if (kGlv) {
    // constant tables, chunk i of entry e of table s at ((6e + i) * 2 + s) * 16
    uint32_t* cw = reinterpret_cast<uint32_t*>(smem);
    for (int idx = tid; idx < 2 * 16 * 24; idx += kWarp) {
      const int s = idx / (16 * 24), e = idx / 24 % 16, k = idx % 24;
      cw[((kChunks * e + k / 4) * 2 + s) * 4 + k % 4] = a.g0[idx];
    }
    if (src < 2) {
      base = sbase + 16u * src;
      stride = 32u;
      neg = 0u - (uint32_t)(a.sflags[(size_t)lane * 2 + src] != 0);
    } else {
      base = sbase + kConstBytes + 16u * (2 * slot + src - 2);
      stride = 16u * 2 * S::kLanes;
    }
  } else {
    base = sbase + 16u * (kSources * slot + src);
    stride = 16u * kSources * S::kLanes;
  }
  if (g < kSources && (!kGlv || src >= 2))
    fill_table_shared(base, stride, pt_load_limbs(Ps + (size_t)lane * 48));
  __syncthreads();
  Pt acc = pt_infinity();
#pragma unroll 1
  for (int w = a.windows - 1; w >= 0; --w) {
#pragma unroll 1
    for (int i = 0; i < 4; ++i) acc = pt_dbl_grp<G>(acc, g);
    Pt e = pt_select16_shared(base, stride, scalar_digit(kl, w));
    if (kGlv) e.y = fe_select(neg, fe_neg(e.y), e.y);
#pragma unroll 1
    for (int s = 0; s < kSources; ++s) acc = pt_add_grp<G>(acc, pt_shfl<G>(e, s), g);
  }
  if (want < a.n && g == 0) pt_store_limbs(a.out + (size_t)lane * 48, acc);
}

}  // namespace grp
}  // namespace pa
