// Device field and point layer for secp256k1 on Hopper (sm_90a).
//
// Replaces the shared device layer of the TPU kernels
// (privacy_auction_tpu/ops/pallas_ec.py:73-336: _propagate, _mul, _addsub,
// _mul_small, _pt_add; _pt_dbl, _fill_table and _entry_select are the group
// forms of ec_group.cuh).
//
// A field element is 8 little-endian 32-bit words, always canonical in
// [0, p), p = 2^256 - C, C = 2^32 + 977.  The TPU kernels needed
// Kogge-Stone carry ladders because the TPU vector unit has no carry flag;
// here every carry rides a 64-bit accumulator, which the compiler turns
// into wide multiply-adds and add-with-carry.
//
// The point add here and the group add and double of ec_group.cuh are RCB16
// Algorithms 7 and 9 for a = 0, in the same order of operations as
// _pt_add/_pt_dbl and the plain PyTorch ec.add / ec.dbl, so with canonical
// field values the projective results agree bit for bit.
#pragma once

#include <cstdint>

namespace pa {

constexpr uint32_t kC0 = 977u;   // C = 2^32 + kC0
constexpr uint32_t kB3 = 21u;    // 3 * b, b = 7

struct Fe {
  uint32_t w[8];
};

struct Pt {
  Fe x, y, z;
};

__device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = 0u;
  return r;
}

__device__ __forceinline__ Pt pt_infinity() {
  Pt r;
  r.x = fe_zero();
  r.y = fe_zero();
  r.y.w[0] = 1u;
  r.z = fe_zero();
  return r;
}

// Branchless select: mask all-ones picks a, zero picks b.
__device__ __forceinline__ Fe fe_select(uint32_t mask, const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = (a.w[i] & mask) | (b.w[i] & ~mask);
  return r;
}

// t (< 2^256) -> canonical: t - p iff t >= p, i.e. iff t + C >= 2^256.
__device__ __forceinline__ Fe fe_cond_sub_p(const uint32_t t[8]) {
  Fe u, v;
  uint64_t d = (uint64_t)t[0] + kC0;
  u.w[0] = (uint32_t)d;
  d >>= 32;
  d += (uint64_t)t[1] + 1u;
  u.w[1] = (uint32_t)d;
  d >>= 32;
#pragma unroll
  for (int i = 2; i < 8; ++i) {
    d += t[i];
    u.w[i] = (uint32_t)d;
    d >>= 32;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) v.w[i] = t[i];
  return fe_select(0u - (uint32_t)d, u, v);
}

// value = t + top * 2^256 with top < 2^34 -> canonical.
__device__ __forceinline__ Fe fe_fold_top(uint32_t t[8], uint64_t top) {
  // top * 2^256 = top * C (mod p) = top * 977 + top * 2^32
  uint64_t d = (uint64_t)t[0] + top * kC0;
  t[0] = (uint32_t)d;
  d >>= 32;
  d += (uint64_t)t[1] + (top & 0xffffffffull);
  t[1] = (uint32_t)d;
  d >>= 32;
  d += (uint64_t)t[2] + (top >> 32);
  t[2] = (uint32_t)d;
  d >>= 32;
#pragma unroll
  for (int i = 3; i < 8; ++i) {
    d += t[i];
    t[i] = (uint32_t)d;
    d >>= 32;
  }
  // d in {0, 1}; when set the value is 2^256 + t with t < top * C < 2^67:
  // fold C once more (cannot carry out again).
  uint64_t e = (uint64_t)t[0] + kC0 * d;
  t[0] = (uint32_t)e;
  e >>= 32;
  e += (uint64_t)t[1] + d;
  t[1] = (uint32_t)e;
  e >>= 32;
#pragma unroll
  for (int i = 2; i < 8; ++i) {
    e += t[i];
    t[i] = (uint32_t)e;
    e >>= 32;
  }
  return fe_cond_sub_p(t);
}

__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b) {
  uint32_t t[8];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += (uint64_t)a.w[i] + b.w[i];
    t[i] = (uint32_t)c;
    c >>= 32;
  }
  // a + b = t + c*2^256 < 2p.  With c set, a + b - p = t + C (no overflow).
  Fe u, v;
  uint64_t d = (uint64_t)t[0] + kC0;
  u.w[0] = (uint32_t)d;
  d >>= 32;
  d += (uint64_t)t[1] + 1u;
  u.w[1] = (uint32_t)d;
  d >>= 32;
#pragma unroll
  for (int i = 2; i < 8; ++i) {
    d += t[i];
    u.w[i] = (uint32_t)d;
    d >>= 32;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) v.w[i] = t[i];
  return fe_select(0u - (uint32_t)((c | d) != 0), u, v);
}

__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b) {
  uint32_t t[8];
  uint32_t bw = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t d = (uint64_t)a.w[i] - b.w[i] - bw;
    t[i] = (uint32_t)d;
    bw = (uint32_t)(d >> 32) & 1u;
  }
  // on borrow, t = a - b + 2^256 and the result is t + p = t - C mod 2^256
  Fe u, v;
  uint32_t br;
  uint64_t d = (uint64_t)t[0] - kC0;
  u.w[0] = (uint32_t)d;
  br = (uint32_t)(d >> 32) & 1u;
  d = (uint64_t)t[1] - 1u - br;
  u.w[1] = (uint32_t)d;
  br = (uint32_t)(d >> 32) & 1u;
#pragma unroll
  for (int i = 2; i < 8; ++i) {
    d = (uint64_t)t[i] - br;
    u.w[i] = (uint32_t)d;
    br = (uint32_t)(d >> 32) & 1u;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) v.w[i] = t[i];
  return fe_select(0u - bw, u, v);
}

__device__ __forceinline__ Fe fe_neg(const Fe& a) { return fe_sub(fe_zero(), a); }

// 8x8 schoolbook product with 64-bit accumulators (64 wide multiplies),
// then the high half folded by C twice and one conditional subtract.
__device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b) {
  uint32_t r[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) r[i] = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c += (uint64_t)a.w[i] * b.w[j] + r[i + j];
      r[i + j] = (uint32_t)c;
      c >>= 32;
    }
    r[i + 8] = (uint32_t)c;
  }
  // lo + hi * (2^32 + 977): word i takes lo[i] + 977*hi[i] + hi[i-1]
  uint32_t t[8];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += (uint64_t)r[i] + (uint64_t)r[8 + i] * kC0 + (i ? r[7 + i] : 0u);
    t[i] = (uint32_t)c;
    c >>= 32;
  }
  return fe_fold_top(t, c + r[15]);
}

// a * k for a small constant k < 2^16.
__device__ __forceinline__ Fe fe_mul_small(const Fe& a, uint32_t k) {
  uint32_t t[8];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += (uint64_t)a.w[i] * k;
    t[i] = (uint32_t)c;
    c >>= 32;
  }
  return fe_fold_top(t, c);
}

// --- the shorter-latency products of the group kernels (ec_group.cuh) ---
// Same canonical values as fe_mul and fe_mul_small; what changes is the
// length of the dependent chain a lone warp waits on.  The product's 64
// partial products are summed by column (independent multiplies,
// independent columns) instead of row by row through one 64-bit
// accumulator, and the reduction picks from two candidates whose carry
// chains run side by side, where fe_fold_top runs three one after the
// other.

// t + top * 2^256 (t < 2^256, top < 2^34) -> canonical, from two chains off
// t: s = t + top*C and u = s + C.  If s overflowed 2^256 the value is
// (s mod 2^256) + C < p, which u holds (and u overflowed); otherwise the
// value is s, or s - p = u mod 2^256 exactly when u overflowed.
__device__ __forceinline__ Fe fe_reduce_fast(const uint32_t t[8], uint64_t top) {
  const uint64_t lo = top * kC0;
  uint64_t cs = (uint64_t)t[0] + lo;
  uint64_t cu = cs + kC0;
  Fe s, u;
  s.w[0] = (uint32_t)cs;
  u.w[0] = (uint32_t)cu;
  cs = (cs >> 32) + t[1] + (top & 0xffffffffull);
  cu = (cu >> 32) + t[1] + (top & 0xffffffffull) + 1u;
  s.w[1] = (uint32_t)cs;
  u.w[1] = (uint32_t)cu;
  cs = (cs >> 32) + t[2] + (top >> 32);
  cu = (cu >> 32) + t[2] + (top >> 32);
  s.w[2] = (uint32_t)cs;
  u.w[2] = (uint32_t)cu;
#pragma unroll
  for (int i = 3; i < 8; ++i) {
    cs = (cs >> 32) + t[i];
    cu = (cu >> 32) + t[i];
    s.w[i] = (uint32_t)cs;
    u.w[i] = (uint32_t)cu;
  }
  return fe_select(0u - (uint32_t)(cu >> 32), u, s);
}

// Column sums f[0..8] (each < 2^48, f[8] < 2^32) of the words of a value
// congruent to the product, carried into 8 words and a top < 2^34, then
// reduced.
__device__ __forceinline__ Fe fe_carry_reduce(const uint64_t f[9]) {
  uint32_t t[8];
  uint64_t c = f[0];
  t[0] = (uint32_t)c;
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    c = (c >> 32) + f[i];
    t[i] = (uint32_t)c;
  }
  return fe_reduce_fast(t, (c >> 32) + f[8]);
}

// The 16 column sums of a 512-bit product (each < 2^36, the last < 2^32)
// -> canonical: the high columns fold onto the low ones by 2^256 = 2^32 +
// 977 (mod p) before any carry runs.
__device__ __forceinline__ Fe fe_fold_columns(const uint64_t col[16]) {
  // sum_j col_j 2^(32j) with col_(8+i) 2^(32(8+i)) = col_(8+i) (977 + 2^32) 2^(32i)
  uint64_t f[9];
  f[0] = col[0] + col[8] * kC0;
#pragma unroll
  for (int i = 1; i < 8; ++i) f[i] = col[i] + col[8 + i] * kC0 + col[7 + i];
  f[8] = col[15];
  return fe_carry_reduce(f);
}

// a * b: the 64 products are independent; column j of the 512-bit product
// sums the low words of a_i b_{j-i} and the high words of a_i b_{j-1-i}
// (16 terms at most, < 2^36).
__device__ __forceinline__ Fe fe_mul_fast(const Fe& a, const Fe& b) {
  uint64_t col[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) col[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint64_t p = (uint64_t)a.w[i] * b.w[k];
      col[i + k] += (uint32_t)p;
      col[i + k + 1] += p >> 32;
    }
  }
  return fe_fold_columns(col);
}

// a * a from 36 products: the 28 products a_i a_k (i < k) summed by column
// and doubled, then the 8 squares a_i^2 added.  The columns are those of
// fe_mul_fast(a, a), which counts each a_i a_k twice, so the result is the
// same canonical value.
__device__ __forceinline__ Fe fe_sqr_fast(const Fe& a) {
  uint64_t col[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) col[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int k = i + 1; k < 8; ++k) {
      const uint64_t p = (uint64_t)a.w[i] * a.w[k];
      col[i + k] += (uint32_t)p;
      col[i + k + 1] += p >> 32;
    }
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) col[j] <<= 1;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint64_t p = (uint64_t)a.w[i] * a.w[i];
    col[2 * i] += (uint32_t)p;
    col[2 * i + 1] += p >> 32;
  }
  return fe_fold_columns(col);
}

// a * k for a small constant k < 2^16.
__device__ __forceinline__ Fe fe_mul_small_fast(const Fe& a, uint32_t k) {
  uint64_t f[9];
  uint64_t hi = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint64_t p = (uint64_t)a.w[i] * k;
    f[i] = (uint32_t)p + hi;
    hi = p >> 32;
  }
  f[8] = hi;
  return fe_carry_reduce(f);
}

// The two field layers, for the point formulas below.
struct FieldRef {
  static __device__ __forceinline__ Fe add(const Fe& a, const Fe& b) { return fe_add(a, b); }
  static __device__ __forceinline__ Fe sub(const Fe& a, const Fe& b) { return fe_sub(a, b); }
  static __device__ __forceinline__ Fe mul(const Fe& a, const Fe& b) { return fe_mul(a, b); }
  static __device__ __forceinline__ Fe mul_small(const Fe& a, uint32_t k) {
    return fe_mul_small(a, k);
  }
};

struct FieldFast {
  static __device__ __forceinline__ Fe add(const Fe& a, const Fe& b) { return fe_add(a, b); }
  static __device__ __forceinline__ Fe sub(const Fe& a, const Fe& b) { return fe_sub(a, b); }
  static __device__ __forceinline__ Fe mul(const Fe& a, const Fe& b) { return fe_mul_fast(a, b); }
  static __device__ __forceinline__ Fe mul_small(const Fe& a, uint32_t k) {
    return fe_mul_small_fast(a, k);
  }
};

// Complete addition, RCB16 Algorithm 7 (a = 0): 12 muls, 3 small muls.
template <class Fd>
__device__ __forceinline__ Pt pt_add_t(const Pt& P, const Pt& Q) {
  Fe t0 = Fd::mul(P.x, Q.x);
  Fe t1 = Fd::mul(P.y, Q.y);
  Fe t2 = Fd::mul(P.z, Q.z);
  Fe u1 = Fd::mul(Fd::add(P.x, P.y), Fd::add(Q.x, Q.y));
  Fe u2 = Fd::mul(Fd::add(P.y, P.z), Fd::add(Q.y, Q.z));
  Fe u3 = Fd::mul(Fd::add(P.x, P.z), Fd::add(Q.x, Q.z));
  Fe t3 = Fd::sub(u1, Fd::add(t0, t1));   // X1Y2 + X2Y1
  Fe t4 = Fd::sub(u2, Fd::add(t1, t2));   // Y1Z2 + Y2Z1
  Fe y3 = Fd::sub(u3, Fd::add(t0, t2));   // X1Z2 + X2Z1
  Fe t0_3 = Fd::mul_small(t0, 3u);
  Fe t2b = Fd::mul_small(t2, kB3);
  Fe y3b = Fd::mul_small(y3, kB3);
  Fe z3p = Fd::add(t1, t2b);
  Fe t1m = Fd::sub(t1, t2b);
  Pt R;
  R.x = Fd::sub(Fd::mul(t3, t1m), Fd::mul(t4, y3b));
  R.y = Fd::add(Fd::mul(t1m, z3p), Fd::mul(y3b, t0_3));
  R.z = Fd::add(Fd::mul(z3p, t4), Fd::mul(t0_3, t3));
  return R;
}

__device__ __noinline__ Pt pt_add(const Pt& P, const Pt& Q) {
  return pt_add_t<FieldRef>(P, Q);
}

// All ones when e == d, else zero, by arithmetic on d < 16.
__device__ __forceinline__ uint32_t digit_mask(uint32_t d, uint32_t e) {
  return 0u - (((d ^ e) - 1u) >> 31);
}

// --- layout conversion: int64 16-bit limbs <-> 32-bit words ---------------

__device__ __forceinline__ Fe fe_load_limbs(const int64_t* l) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    r.w[i] = (uint32_t)l[2 * i] | ((uint32_t)l[2 * i + 1] << 16);
  return r;
}

__device__ __forceinline__ void fe_store_limbs(int64_t* l, const Fe& a) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    l[2 * i] = (int64_t)(a.w[i] & 0xffffu);
    l[2 * i + 1] = (int64_t)(a.w[i] >> 16);
  }
}

__device__ __forceinline__ Pt pt_load_limbs(const int64_t* l) {
  Pt r;
  r.x = fe_load_limbs(l);
  r.y = fe_load_limbs(l + 16);
  r.z = fe_load_limbs(l + 32);
  return r;
}

__device__ __forceinline__ void pt_store_limbs(int64_t* l, const Pt& P) {
  fe_store_limbs(l, P.x);
  fe_store_limbs(l + 16, P.y);
  fe_store_limbs(l + 32, P.z);
}

// 4-bit window w (least significant first) of a scalar's 16-bit limbs.
// The window index is public; only the digit's value is secret.
__device__ __forceinline__ uint32_t scalar_digit(const int64_t* k, int w) {
  return (uint32_t)(k[w >> 2] >> (4 * (w & 3))) & 0xfu;
}

}  // namespace pa
