// Device field and point layer for secp256k1 on Hopper (sm_90a).
//
// Replaces the shared device layer of the TPU kernels
// (privacy_auction_tpu/ops/pallas_ec.py:73-336: _propagate, _mul, _addsub,
// _mul_small, _pt_add, _pt_dbl, _fill_table, _entry_select).
//
// A field element is 8 little-endian 32-bit words, always canonical in
// [0, p), p = 2^256 - C, C = 2^32 + 977.  The TPU kernels needed
// Kogge-Stone carry ladders because the TPU vector unit has no carry flag;
// here every carry rides a 64-bit accumulator, which the compiler turns
// into wide multiply-adds and add-with-carry.
//
// Point add and double are RCB16 Algorithms 7 and 9 for a = 0, in the same
// order of operations as _pt_add/_pt_dbl and the plain PyTorch ec.add /
// ec.dbl, so with canonical field values the projective results agree bit
// for bit.
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

// Complete addition, RCB16 Algorithm 7 (a = 0): 12 muls, 3 small muls.
__device__ __noinline__ Pt pt_add(const Pt& P, const Pt& Q) {
  Fe t0 = fe_mul(P.x, Q.x);
  Fe t1 = fe_mul(P.y, Q.y);
  Fe t2 = fe_mul(P.z, Q.z);
  Fe u1 = fe_mul(fe_add(P.x, P.y), fe_add(Q.x, Q.y));
  Fe u2 = fe_mul(fe_add(P.y, P.z), fe_add(Q.y, Q.z));
  Fe u3 = fe_mul(fe_add(P.x, P.z), fe_add(Q.x, Q.z));
  Fe t3 = fe_sub(u1, fe_add(t0, t1));   // X1Y2 + X2Y1
  Fe t4 = fe_sub(u2, fe_add(t1, t2));   // Y1Z2 + Y2Z1
  Fe y3 = fe_sub(u3, fe_add(t0, t2));   // X1Z2 + X2Z1
  Fe t0_3 = fe_mul_small(t0, 3u);
  Fe t2b = fe_mul_small(t2, kB3);
  Fe y3b = fe_mul_small(y3, kB3);
  Fe z3p = fe_add(t1, t2b);
  Fe t1m = fe_sub(t1, t2b);
  Pt R;
  R.x = fe_sub(fe_mul(t3, t1m), fe_mul(t4, y3b));
  R.y = fe_add(fe_mul(t1m, z3p), fe_mul(y3b, t0_3));
  R.z = fe_add(fe_mul(z3p, t4), fe_mul(t0_3, t3));
  return R;
}

// Complete doubling, RCB16 Algorithm 9 (a = 0): 8 muls, 4 small muls.
__device__ __noinline__ Pt pt_dbl(const Pt& P) {
  Fe t0 = fe_mul(P.y, P.y);
  Fe t1 = fe_mul(P.y, P.z);
  Fe t2 = fe_mul(P.z, P.z);
  Fe xy = fe_mul(P.x, P.y);
  Fe z3a = fe_mul_small(t0, 8u);
  Fe t2b = fe_mul_small(t2, kB3);
  Fe t2c = fe_mul_small(t2, 3u * kB3);
  Fe y3a = fe_add(t0, t2b);
  Fe t0m = fe_sub(t0, t2c);
  Pt R;
  R.x = fe_mul_small(fe_mul(t0m, xy), 2u);
  R.y = fe_add(fe_mul(t2b, z3a), fe_mul(t0m, y3a));
  R.z = fe_mul(t1, z3a);
  return R;
}

__device__ __forceinline__ Pt pt_dbl4(Pt acc) {
#pragma unroll 1
  for (int i = 0; i < 4; ++i) acc = pt_dbl(acc);
  return acc;
}

// [inf, P, 2P, ..., 15P], entry i+1 = add(entry i, P) as _fill_table.
__device__ __noinline__ void pt_fill_table(Pt* T, const Pt& P) {
  T[0] = pt_infinity();
  T[1] = P;
#pragma unroll 1
  for (int i = 2; i < 16; ++i) T[i] = pt_add(T[i - 1], P);
}

// Constant-time T[d]: every entry is read and masked in; no address is
// formed from the digit (the stance of _entry_select).
__device__ __noinline__ Pt pt_select16(const Pt* T, uint32_t d) {
  Pt r;
  uint32_t* rw = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int k = 0; k < 24; ++k) rw[k] = 0u;
#pragma unroll 1
  for (uint32_t e = 0; e < 16; ++e) {
    const uint32_t mask = 0u - (uint32_t)(e == d);
    const uint32_t* tw = reinterpret_cast<const uint32_t*>(&T[e]);
#pragma unroll
    for (int k = 0; k < 24; ++k) rw[k] |= tw[k] & mask;
  }
  return r;
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
