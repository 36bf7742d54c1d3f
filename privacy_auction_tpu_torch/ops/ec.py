"""Batched elliptic-curve point operations in PyTorch.

Counterpart of `privacy_auction_tpu/ops/ec.py`.  Points are projective
(X:Y:Z) limb tensors of shape ``(..., 3, 16)``; Z == 0 encodes the point at
infinity (canonically (0:1:0)).  The group law is the complete
Renes-Costello-Batina formulas: for a = 0 (secp256k1) Algorithms 7 and 9,
for any other a (P-256) Algorithms 1 and 3; one branchless code path for
P+Q, P+P, P+(-P) and the identity.

Each of the seven EC kernels -- the four ladders of the protocols' path
and, for a curve without GLV (reached today through the kernel validator),
the 64-window ladders and the single add -- has two versions here:

* a kernel written by hand in CUDA C++ (`ops/cuda_ec.py`,
  `csrc/ec_ladders.cu`), launched for CUDA tensors;
* its plain PyTorch version (`*_plain` below, `add` for `pt_add`), which
  CPU tensors take and which the tests and `chip_smoke.py` hold the kernel
  against.

Both run the same sequence of formulas, and every field value is
canonical, so they agree bit for bit in projective coordinates.  The
dispatch is the JAX package's `_pallas_ok` with the device in place of the
platform: a tensor of a curve the kernels are written for (a = 0 and a
fold-friendly p: secp256k1) launches the kernel on any device but the
CPU, and raises where it cannot run; a CPU tensor, and a tensor of any
other curve (P-256) on any device, takes the plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from ..curves import (COMB_SIZE, COMB_WINDOW, COMB_WINDOWS, GLV_WINDOWS, Curve,
                      encode_host_point)
from . import cuda_ec
from . import field as F

LIMBS = F.LIMBS


# --------------------------------------------------------------------------
# construction / predicates
# --------------------------------------------------------------------------

def infinity(device, batch_shape=()) -> torch.Tensor:
    """The point at infinity (0:1:0), broadcast to a batch."""
    inf = F.const(encode_host_point(None), device)
    return inf.expand(tuple(batch_shape) + (3, LIMBS))


def from_affine(x, y):
    """Affine limb coordinates -> projective point (Z=1)."""
    return torch.stack([x, y, F.const(1, x.device, x.shape[:-1])], dim=-2)


def generator(curve: Curve, device, batch_shape=()) -> torch.Tensor:
    G = curve.tensor("generator_affine", device)
    return from_affine(G[0], G[1]).expand(tuple(batch_shape) + (3, LIMBS))


def is_infinity(P):
    return F.is_zero(P[..., 2, :])


def select(cond, P, Q):
    """Branchless point select: cond (...,) -> (..., 3, 16)."""
    return torch.where(cond[..., None, None], P, Q)


def neg(curve: Curve, P):
    """-(X:Y:Z) = (X:-Y:Z)."""
    y = P[..., 1, :]
    return torch.stack([P[..., 0, :], F.neg(curve.fp, y), P[..., 2, :]], dim=-2)


def eq(curve: Curve, P, Q):
    """Projective equality (EC_POINT_cmp equivalent): cross-multiplied."""
    fp = curve.fp
    P, Q = torch.broadcast_tensors(P, Q)
    m = F.mul(fp,
              torch.stack([P[..., 0, :], P[..., 1, :], Q[..., 0, :], Q[..., 1, :]]),
              torch.stack([Q[..., 2, :], Q[..., 2, :], P[..., 2, :], P[..., 2, :]]))
    return F.eq(m[0], m[2]) & F.eq(m[1], m[3])


# --------------------------------------------------------------------------
# group law (complete formulas, a = 0)
# --------------------------------------------------------------------------

def _consts_a_b3(curve: Curve, like):
    """a and 3b as full field elements broadcast to `like` (..., 16)."""
    return (F.const(curve.a_limbs, like.device, like.shape[:-1]),
            F.const(curve.b3_limbs, like.device, like.shape[:-1]))


def _add_generic(curve: Curve, P, Q):
    """Complete projective addition for any a (RCB16 Algorithm 1): 12 field
    muls, 3 a-muls and 2 b3-muls, in the JAX package's four batched mul
    calls (a and 3b are full field constants: P-256's are full-width)."""
    fp = curve.fp
    P, Q = torch.broadcast_tensors(P, Q)
    X1, Y1, Z1 = P[..., 0, :], P[..., 1, :], P[..., 2, :]
    X2, Y2, Z2 = Q[..., 0, :], Q[..., 1, :], Q[..., 2, :]
    a, b3 = _consts_a_b3(curve, X1)

    pre = F.add(fp, torch.stack([X1, X2, Y1, Y2, X1, X2]),
                torch.stack([Y1, Y2, Z1, Z2, Z1, Z2]))
    g1 = F.mul(fp, torch.stack([X1, Y1, Z1, pre[0], pre[2], pre[4]]),
               torch.stack([X2, Y2, Z2, pre[1], pre[3], pre[5]]))
    t0, t1, t2, u1, u2, u3 = g1.unbind(0)
    s = F.add(fp, torch.stack([t0, t1, t0]), torch.stack([t1, t2, t2]))
    t3, t5, t4 = F.sub(fp, torch.stack([u1, u2, u3]), s).unbind(0)
    # X1Y2 + X2Y1, Y1Z2 + Y2Z1, X1Z2 + X2Z1

    at4, bt2, at2, bt4 = F.mul(fp, torch.stack([a, b3, a, b3]),
                               torch.stack([t4, t2, t2, t4])).unbind(0)
    Z3p = F.add(fp, at4, bt2)                      # a*t4 + b3*t2
    t0_3 = F.mul_small(fp, t0, 3)
    X3p, t2m = F.sub(fp, torch.stack([t1, t0]),    # t1 - Z3p, t0 - a*t2
                     torch.stack([Z3p, at2])).unbind(0)
    Z3q, t1n = F.add(fp, torch.stack([t1, t0_3]),  # t1 + Z3p, 3*t0 + a*t2
                     torch.stack([Z3p, at2])).unbind(0)

    g3 = F.mul(fp, torch.stack([a, X3p]), torch.stack([t2m, Z3q]))
    t4n = F.add(fp, bt4, g3[0])                    # b3*t4 + a*(t0 - a*t2)
    g4 = F.mul(fp, torch.stack([t1n, t5, t3, t3, t5]),
               torch.stack([t4n, t4n, X3p, t1n, Z3q]))
    Y3, Z3 = F.add(fp, torch.stack([g3[1], g4[4]]),
                   torch.stack([g4[0], g4[3]])).unbind(0)
    X3 = F.sub(fp, g4[2], g4[1])
    return torch.stack([X3, Y3, Z3], dim=-2)


def _dbl_generic(curve: Curve, P):
    """Complete projective doubling for any a (RCB16 Algorithm 3)."""
    fp = curve.fp
    X, Y, Z = P[..., 0, :], P[..., 1, :], P[..., 2, :]
    a, b3 = _consts_a_b3(curve, X)

    t0, t1, t2, xy, xz, yz = F.mul(
        fp, torch.stack([X, Y, Z, X, X, Y]),
        torch.stack([X, Y, Z, Y, Z, Z])).unbind(0)
    t3, z3t, t2c = F.add(fp, torch.stack([xy, xz, yz]),
                         torch.stack([xy, xz, yz])).unbind(0)  # 2XY, 2XZ, 2YZ

    az3, bt2, at2, bz3 = F.mul(fp, torch.stack([a, b3, a, b3]),
                               torch.stack([z3t, t2, t2, z3t])).unbind(0)
    Y3p = F.add(fp, az3, bt2)                      # a*2XZ + b3*Z^2
    t0_3 = F.mul_small(fp, t0, 3)
    X3p, t3m = F.sub(fp, torch.stack([t1, t0]),    # t1 - Y3p, X^2 - a*Z^2
                     torch.stack([Y3p, at2])).unbind(0)
    Y3q, t0n = F.add(fp, torch.stack([t1, t0_3]),  # t1 + Y3p, 3X^2 + a*Z^2
                     torch.stack([Y3p, at2])).unbind(0)

    g3 = F.mul(fp, torch.stack([a, X3p]), torch.stack([t3m, Y3q]))
    t3n = F.add(fp, g3[0], bz3)                    # a*(X^2 - aZ^2) + b3*2XZ
    g4 = F.mul(fp, torch.stack([t0n, t2c, t3, t2c]),
               torch.stack([t3n, t3n, X3p, t1]))
    Y3 = F.add(fp, g3[1], g4[0])
    X3 = F.sub(fp, g4[2], g4[1])
    Z3 = F.mul_small(fp, g4[3], 4)                 # 8 Y^3 Z
    return torch.stack([X3, Y3, Z3], dim=-2)


def add(curve: Curve, P, Q):
    """Complete projective addition (RCB16 Algorithm 7, a=0; Algorithm 1
    for any other a).

    For a = 0: 12 field muls + 3 small-constant muls, grouped into two
    batched mul calls of six, as the JAX package does.
    """
    if not curve.a_is_zero:
        return _add_generic(curve, P, Q)
    fp = curve.fp
    b3 = curve.b3
    P, Q = torch.broadcast_tensors(P, Q)
    X1, Y1, Z1 = P[..., 0, :], P[..., 1, :], P[..., 2, :]
    X2, Y2, Z2 = Q[..., 0, :], Q[..., 1, :], Q[..., 2, :]

    pre = F.add(fp, torch.stack([X1, X2, Y1, Y2, X1, X2]),
                torch.stack([Y1, Y2, Z1, Z2, Z1, Z2]))
    g1 = F.mul(fp, torch.stack([X1, Y1, Z1, pre[0], pre[2], pre[4]]),
               torch.stack([X2, Y2, Z2, pre[1], pre[3], pre[5]]))
    t0, t1, t2, u1, u2, u3 = g1.unbind(0)

    s = F.add(fp, torch.stack([t0, t1, t0]), torch.stack([t1, t2, t2]))
    t3, t4, y3 = F.sub(fp, torch.stack([u1, u2, u3]), s).unbind(0)

    t0_3, t2b, y3b = F.mul_small_vec(
        fp, torch.stack([t0, t2, y3]), [3, b3, b3]).unbind(0)
    z3p = F.add(fp, t1, t2b)
    t1m = F.sub(fp, t1, t2b)

    g2 = F.mul(fp, torch.stack([t4, t3, y3b, t1m, t0_3, z3p]),
               torch.stack([y3b, t1m, t0_3, z3p, t3, t4]))
    X3 = F.sub(fp, g2[1], g2[0])
    fin = F.add(fp, torch.stack([g2[3], g2[5]]), torch.stack([g2[2], g2[4]]))
    return torch.stack([X3, fin[0], fin[1]], dim=-2)


def dbl(curve: Curve, P):
    """Complete projective doubling (RCB16 Algorithm 9, a=0: 8 field muls
    + small-constant muls, in two batched calls of four; Algorithm 3 for
    any other a)."""
    if not curve.a_is_zero:
        return _dbl_generic(curve, P)
    fp = curve.fp
    b3 = curve.b3
    X, Y, Z = P[..., 0, :], P[..., 1, :], P[..., 2, :]

    t0, t1, t2, xy = F.mul(fp, torch.stack([Y, Y, Z, X]),
                           torch.stack([Y, Z, Z, Y])).unbind(0)
    z3a, t2b, t2c = F.mul_small_vec(
        fp, torch.stack([t0, t2, t2]), [8, b3, 3 * b3]).unbind(0)
    y3a = F.add(fp, t0, t2b)
    t0m = F.sub(fp, t0, t2c)

    g2 = F.mul(fp, torch.stack([t2b, t1, t0m, t0m]),
               torch.stack([z3a, z3a, y3a, xy]))
    fin = F.add(fp, torch.stack([g2[0], g2[3]]), torch.stack([g2[2], g2[3]]))
    return torch.stack([fin[1], fin[0], g2[1]], dim=-2)


def _dbl4(curve: Curve, acc):
    for _ in range(COMB_WINDOW):
        acc = dbl(curve, acc)
    return acc


# --------------------------------------------------------------------------
# window digits and per-lane tables
# --------------------------------------------------------------------------

def window_digits(k, windows: int = COMB_WINDOWS):
    """The low `windows` 4-bit digits of scalar limbs k, least significant
    first: (windows, ...) int64."""
    shifts = torch.arange(0, 16, COMB_WINDOW, device=k.device)
    d = (k.unsqueeze(-1) >> shifts) & 0xF                   # (..., 16, 4)
    d = d.reshape(k.shape[:-1] + (COMB_WINDOWS,))
    return d.movedim(-1, 0)[:windows]


def _select_entry(table, digit):
    """Per-lane lookup: table (16, batch..., 3, L), digit (batch...)."""
    idx = digit[None, ..., None, None].expand((1,) + table.shape[1:])
    return torch.gather(table, 0, idx)[0]


def _build_table(curve: Curve, P):
    """Per-lane 16-entry window table [inf, P, 2P, ..., 15P]; entry i+1 is
    add(entry i, P), as the TPU kernels fill theirs."""
    entries = [infinity(P.device, P.shape[:-2]), P]
    for _ in range(COMB_SIZE - 2):
        entries.append(add(curve, entries[-1], P))
    return torch.stack(entries)


def _multi_ladder(curve: Curve, Ps, ks, windows: int):
    """Shared-doubling Straus ladder over S stacked sources.

    Ps: (S, batch..., 3, L); ks: S scalar limb tensors (batch..., L).  Per
    window, most significant first: 4 doublings, then one add per source in
    source order.
    """
    S = Ps.shape[0]
    tables = _build_table(curve, Ps)               # (16, S, batch..., 3, L)
    digs = [window_digits(k, windows) for k in ks]
    acc = infinity(Ps.device, Ps.shape[1:-2])
    for w in reversed(range(windows)):
        acc = _dbl4(curve, acc)
        for s in range(S):
            acc = add(curve, acc, _select_entry(tables[:, s], digs[s][w]))
    return acc


# --------------------------------------------------------------------------
# plain versions of the kernels
# --------------------------------------------------------------------------

def mul_comb_plain(curve: Curve, table, k):
    """k*B over a (64, 16, 3, L) comb table of B: one complete add per
    window, least significant window first.  Plain version of the
    `mul_comb` kernel."""
    digs = window_digits(k)
    acc = infinity(k.device, k.shape[:-1])
    for w in range(COMB_WINDOWS):
        acc = add(curve, acc, table[w][digs[w]])
    return acc


def scalar_mul_windows_plain(curve: Curve, P, k, windows: int = COMB_WINDOWS):
    """k*P over the low `windows` 4-bit windows (all 64 by default): the
    Straus ladder with one source.  Plain version of the `scalar_mul`
    kernel."""
    return _multi_ladder(curve, P[None], [k], windows)


def dual_mul_windows_plain(curve: Curve, P1, k1, P2, k2, windows: int):
    """k1*P1 + k2*P2 over the low `windows` 4-bit windows.  Plain version of
    the `dual_mul` kernel."""
    return _multi_ladder(curve, torch.stack([P1, P2]), [k1, k2], windows)


def quad_mul_windows_plain(curve: Curve, P1, k1, P2, k2, P3, k3, P4, k4,
                           windows: int):
    """sum k_i*P_i over one shared doubling chain.  Plain version of the
    `quad_mul` kernel."""
    return _multi_ladder(curve, torch.stack([P1, P2, P3, P4]),
                         [k1, k2, k3, k4], windows)


def base_mul_add_glv_plain(curve: Curve, P1, t1, P2, t2, s1, s2, sflags,
                           windows: int):
    """g^s * P^t with both scalars GLV-split.  Plain version of the
    `base_mul_add_glv` kernel.

    P1/P2 are the sign-adjusted +-P / +-phi(P) with magnitudes t1/t2; s1/s2
    are the magnitudes of s's halves, their signs in sflags (..., 2).  The
    generator side reads the constant window-0 tables of G and phi(G)
    (affine, Z = 1) and negates the fetched Y where the sign flag is set;
    any (0:y:0) is a valid infinity for the complete formulas.  Per window:
    4 doublings, then the G, phi(G), P1, P2 entries in that order.
    """
    fp = curve.fp
    g0 = curve.tensor("g0_tables", P1.device)      # (2, 16, 3, L)
    tables = _build_table(curve, torch.stack([P1, P2]))
    dt = [window_digits(t1, windows), window_digits(t2, windows)]
    ds = [window_digits(s1, windows), window_digits(s2, windows)]
    acc = infinity(P1.device, P1.shape[:-2])
    for w in reversed(range(windows)):
        acc = _dbl4(curve, acc)
        for j in range(2):
            e = g0[j][ds[j][w]]
            y = F.select(sflags[..., j] != 0, F.neg(fp, e[..., 1, :]),
                         e[..., 1, :])
            acc = add(curve, acc, torch.stack([e[..., 0, :], y, e[..., 2, :]],
                                              dim=-2))
        for j in range(2):
            acc = add(curve, acc, _select_entry(tables[:, j], dt[j][w]))
    return acc


def base_mul_add_plain(curve: Curve, s, P, t):
    """g^s * P^t without GLV, one doubling chain over the full scalars.
    Plain version of the `base_mul_add` kernel.

    Per window, most significant first: 4 doublings, the add of the
    constant window-0 entry s_w*G (affine, Z = 1, the table the kernel
    reads), then the add of the per-lane entry t_w*P.
    """
    g0 = curve.tensor("g0_table", P.device)            # (16, 3, L)
    table = _build_table(curve, P)
    ds, dt = window_digits(s), window_digits(t)
    acc = infinity(P.device, P.shape[:-2])
    for w in reversed(range(COMB_WINDOWS)):
        acc = _dbl4(curve, acc)
        acc = add(curve, acc, g0[ds[w]])
        acc = add(curve, acc, _select_entry(table, dt[w]))
    return acc


# --------------------------------------------------------------------------
# dispatch: the kernel for a curve it is written for on any device but the
# CPU (it raises where it cannot run); the plain version otherwise
# --------------------------------------------------------------------------

def kernel_curve(curve: Curve) -> bool:
    """The JAX package's `_pallas_ok` test of the curve: a = 0 and a base
    field of the form 2**256 - 2**32 - k0, the curves the kernels are
    written for (secp256k1); P-256 runs the generic plain path."""
    return curve.a_is_zero and F._fast_k0(curve.fp) is not None


def _plain(curve: Curve, t) -> bool:
    return t.device.type == "cpu" or not kernel_curve(curve)


def mul_comb(curve: Curve, table, k):
    """Comb scalar mult against a (64, 16, 3, L) table of any base point."""
    if _plain(curve, k):
        return mul_comb_plain(curve, table, k)
    return cuda_ec.mul_comb(curve, table, k)


def mul_base(curve: Curve, k):
    """Fixed-base scalar mult k*G via the precomputed comb table."""
    return mul_comb(curve, curve.tensor("comb_table", k.device), k)


def scalar_mul_windows(curve: Curve, P, k, windows: int = COMB_WINDOWS):
    """k*P over `windows` 4-bit windows, without GLV (`pallas_ec.scalar_mul`)."""
    if _plain(curve, P):
        return scalar_mul_windows_plain(curve, P, k, windows)
    return cuda_ec.scalar_mul(curve, P, k, windows)


def dual_mul_windows(curve: Curve, P1, k1, P2, k2, windows: int):
    if _plain(curve, P1):
        return dual_mul_windows_plain(curve, P1, k1, P2, k2, windows)
    return cuda_ec.dual_mul(curve, P1, k1, P2, k2, windows)


def quad_mul_windows(curve: Curve, P1, k1, P2, k2, P3, k3, P4, k4,
                     windows: int):
    if _plain(curve, P1):
        return quad_mul_windows_plain(curve, P1, k1, P2, k2, P3, k3, P4, k4,
                                      windows)
    return cuda_ec.quad_mul(curve, P1, k1, P2, k2, P3, k3, P4, k4, windows)


def base_mul_add_glv(curve: Curve, P1, t1, P2, t2, s1, s2, sflags,
                     windows: int):
    if _plain(curve, P1):
        return base_mul_add_glv_plain(curve, P1, t1, P2, t2, s1, s2, sflags,
                                      windows)
    return cuda_ec.base_mul_add_glv(
        curve, P1, t1, P2, t2, s1, s2, sflags,
        curve.tensor("g0_tables", P1.device), windows)


def base_mul_add_windows(curve: Curve, s, P, t):
    """g^s * P^t without GLV, 64 windows (`pallas_ec.base_mul_add`)."""
    if _plain(curve, P):
        return base_mul_add_plain(curve, s, P, t)
    return cuda_ec.base_mul_add(curve, s, P, t,
                                curve.tensor("g0_table", P.device))


def pt_add(curve: Curve, P, Q):
    """One complete add per lane, as a kernel launch on the card (the TPU's
    `_pt_add_kernel`); `add` is its plain version."""
    if _plain(curve, P):
        return add(curve, P, Q)
    return cuda_ec.pt_add(curve, P, Q)


# --------------------------------------------------------------------------
# GLV endomorphism
# --------------------------------------------------------------------------

def glv_decompose(curve: Curve, k):
    """Branchless GLV split: k (..., 16) mod n -> (|k1|, k1<0, |k2|, k2<0)
    with k1 + k2*lam = k mod n and |ki| < 2**132.

    c_i = round(k * g_i / 2**272) from one wide limb product plus a
    rounding bit; the signed lattice combination runs in mod-n arithmetic,
    and the representative's half-range gives sign and magnitude.
    """
    glv = curve.glv
    fn = curve.fn
    batch = k.shape[:-1]
    dev = k.device
    g12 = F.const(np.stack([glv.g1_limbs, glv.g2_limbs]), dev)
    g12 = g12.reshape((2,) + (1,) * len(batch) + (10,)).expand((2,) + batch + (10,))
    prod = F._mul_raw(k.expand((2,) + batch + (LIMBS,)), g12)   # (2, ..., 26)
    rnd = prod.clone()
    rnd[..., 16] += 0x8000                                      # + 2**271
    digits, _ = F._propagate(rnd, 1 << 17)
    c = F._fit(digits[..., 17:], LIMBS)                         # >> 272
    c1, c2 = c[0], c[1]

    consts = F.const(np.stack([glv.a1n_limbs, glv.a2n_limbs, glv.b1n_limbs,
                               glv.b2n_limbs]), dev)
    m = F.mul(fn, torch.stack([c1, c2, c1, c2]),
              consts.reshape((4,) + (1,) * len(batch) + (LIMBS,)))
    sums = F.add(fn, torch.stack([m[0], m[2]]), torch.stack([m[1], m[3]]))
    km = F.sub(fn, torch.stack([k, torch.zeros_like(k)]), sums)

    half = F.const(curve.host.n // 2, dev, (2,) + batch)
    _, borrow = F._sub_raw(half, km)                 # borrow iff km > n/2
    negf = borrow == 1
    mag = F.select(negf, F.neg(fn, km), km)
    return mag[0], negf[0], mag[1], negf[1]


def endo_apply(curve: Curve, P):
    """The GLV endomorphism phi(X:Y:Z) = (beta*X : Y : Z) = lam * P."""
    beta = F.const(curve.glv.beta_limbs, P.device)
    return torch.stack(
        [F.mul(curve.fp, P[..., 0, :], beta), P[..., 1, :], P[..., 2, :]],
        dim=-2)


def _glv_split_point(curve: Curve, P, k):
    """(P1, k1, P2, k2) with k*P = k1*P1 + k2*P2, |ki| < 2**132."""
    k1, s1, k2, s2 = glv_decompose(curve, k)
    P1 = select(s1, neg(curve, P), P)
    P2full = endo_apply(curve, P)
    P2 = select(s2, neg(curve, P2full), P2full)
    return P1, k1, P2, k2


def _broadcast(points, scalars):
    batch = torch.broadcast_shapes(*[p.shape[:-2] for p in points],
                                   *[s.shape[:-1] for s in scalars])
    return ([p.expand(batch + (3, LIMBS)) for p in points],
            [s.expand(batch + (LIMBS,)) for s in scalars])


def scalar_mul(curve: Curve, P, k):
    """Variable-base k*P as k1*P + k2*phi(P): a 33-window dual ladder; on a
    curve without GLV the 64-window ladder."""
    (P,), (k,) = _broadcast([P], [k])
    if curve.glv is None:
        return scalar_mul_windows(curve, P, k, COMB_WINDOWS)
    P1, k1, P2, k2 = _glv_split_point(curve, P, k)
    return dual_mul_windows(curve, P1, k1, P2, k2, GLV_WINDOWS)


def dual_mul(curve: Curve, P, kp, Q, kq):
    """kp*P + kq*Q as a four-half-scalar shared-doubling ladder; on a curve
    without GLV the 64-window dual ladder."""
    (P, Q), (kp, kq) = _broadcast([P, Q], [kp, kq])
    if curve.glv is None:
        return dual_mul_windows(curve, P, kp, Q, kq, COMB_WINDOWS)
    P1, kp1, P2, kp2 = _glv_split_point(curve, P, kp)
    Q1, kq1, Q2, kq2 = _glv_split_point(curve, Q, kq)
    return quad_mul_windows(curve, P1, kp1, P2, kp2, Q1, kq1, Q2, kq2,
                            GLV_WINDOWS)


def base_mul_add(curve: Curve, s, P, t):
    """g^s * P^t with both scalars GLV-split; on a curve without GLV one
    64-window chain over the full scalars."""
    (P,), (s, t) = _broadcast([P], [s, t])
    if curve.glv is None:
        return base_mul_add_windows(curve, s, P, t)
    P1, t1, P2, t2 = _glv_split_point(curve, P, t)
    s1, ss1, s2, ss2 = glv_decompose(curve, s)
    sflags = torch.stack([ss1, ss2], dim=-1).to(F.DTYPE)
    return base_mul_add_glv(curve, P1, t1, P2, t2, s1, s2, sflags,
                            GLV_WINDOWS)


# --------------------------------------------------------------------------
# affine conversion / serialization
# --------------------------------------------------------------------------

def to_affine(curve: Curve, P):
    """Projective -> affine (x, y) limb pair; infinity maps to (0, 0)."""
    fp = curve.fp
    zinv = F.inv(fp, P[..., 2, :])
    xy = F.mul(fp, P[..., :2, :], zinv.unsqueeze(-2))
    return xy[..., 0, :], xy[..., 1, :]


def serialize_uncompressed(curve: Curve, P):
    """SEC1 uncompressed encoding (..., 65) uint8: 0x04 || X_be || Y_be;
    infinity is 65 zero bytes, as in the JAX package."""
    x, y = to_affine(curve, P)
    return serialize_affine(x, y, is_infinity(P))


def serialize_affine(x, y, inf=None):
    """`serialize_uncompressed` of already-affine coordinates x, y (..., 16)
    -> (..., 65) uint8: the prefix byte is 0 where `inf` (by default where
    x = y = 0), else 4."""
    if inf is None:
        inf = F.is_zero(x) & F.is_zero(y)
    prefix = torch.where(inf, 0, 4).to(torch.uint8).unsqueeze(-1)
    return torch.cat([prefix, F.to_bytes_be(x), F.to_bytes_be(y)], dim=-1)


def on_curve(curve: Curve, P):
    """Projective on-curve check Y^2 Z == X^3 + a X Z^2 + b Z^3 -> bool
    (...,); the a term only for a != 0, as the JAX package."""
    fp = curve.fp
    X, Y, Z = P[..., 0, :], P[..., 1, :], P[..., 2, :]
    lhs = F.mul(fp, F.mul(fp, Y, Y), Z)
    x3 = F.mul(fp, F.mul(fp, X, X), X)
    z2 = F.mul(fp, Z, Z)
    z3 = F.mul(fp, z2, Z)
    rhs = F.add(fp, x3, F.mul(fp, z3, F.const(curve.b_limbs, Z.device,
                                               Z.shape[:-1])))
    if not curve.a_is_zero:
        axz2 = F.mul(fp, F.mul(fp, X, z2),
                     F.const(curve.a_limbs, X.device, X.shape[:-1]))
        rhs = F.add(fp, rhs, axz2)
    return F.eq(lhs, rhs)


# --------------------------------------------------------------------------
# reductions over point axes (fixed tree order, as the JAX package)
# --------------------------------------------------------------------------

def ec_prefix_scan(curve: Curve, P, dim: int = 0):
    """Inclusive prefix sums of points along `dim`: Hillis-Steele, log2(n)
    levels of shift-and-add, the same tree as the JAX package so the
    projective limbs agree."""
    P = P.movedim(dim, 0)
    n = P.shape[0]
    if n == 1:
        return P.movedim(0, dim)
    inf = infinity(P.device, P.shape[:-2])
    rows = torch.arange(n, device=P.device).reshape((n,) + (1,) * (P.dim() - 3))
    v = P
    for level in range((n - 1).bit_length()):
        s = 1 << level
        shifted = select(rows >= s, torch.roll(v, s, dims=0), inf)
        v = add(curve, v, shifted)
    return v.movedim(0, dim)


def ec_sum(curve: Curve, P, dim: int = 0):
    """Point sum along `dim` (last prefix of ec_prefix_scan)."""
    return ec_prefix_scan(curve, P.movedim(dim, 0), dim=0)[-1]


# --------------------------------------------------------------------------
# host-side helpers for tests / setup
# --------------------------------------------------------------------------

def encode_host_points(points, device="cuda") -> torch.Tensor:
    """List of host affine points (or None) -> (len, 3, 16) projective limbs
    on `device`, the GPU unless the caller asks for the CPU."""
    return torch.as_tensor(np.stack([encode_host_point(p) for p in points]),
                           dtype=F.DTYPE).to(device)


def decode_host_point(curve: Curve, P):
    """Single point -> host affine pair or None (test helper)."""
    z = F.limbs_to_int(P[2])
    if z == 0:
        return None
    p = curve.host.p
    zi = pow(z, p - 2, p)
    return (F.limbs_to_int(P[0]) * zi % p, F.limbs_to_int(P[1]) * zi % p)
