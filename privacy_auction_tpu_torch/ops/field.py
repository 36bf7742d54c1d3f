"""Batched 256-bit modular arithmetic in PyTorch.

Counterpart of `privacy_auction_tpu/ops/field.py`, with the same layout at
every public function: a field element is 16 little-endian limbs of 16 bits,
shape ``(..., 16)``.  Limbs are held in ``int64`` tensors: torch on the CPU
has no ``>>`` for ``uint32``, and int64 leaves room to accumulate limb
products without carries.

Every function returns canonical values in [0, m), so results are
bit-identical to the JAX package however the intermediate columns are
formed.  Reduction follows the JAX package's choice by modulus: fold
reduction for m = 2**256 - K with K < 2**136 (both secp256k1 fields):
replace H*2**256 + L by L + H*K until the value is below 2m, then one
conditional subtract; Barrett reduction (HAC 14.42) otherwise (both P-256
fields, whose K ~ 2**224 would barely shrink under folding).  Everything
is branchless over the batch; the only Python control flow depends on
static bounds, never on data.

These plain tensor functions run on whatever device their inputs lie on.
The CUDA kernels (`ops/cuda_ec.py`) keep their own field layer in
`csrc/ec_device.cuh`.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field as dc_field
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as TF

RADIX_BITS = 16
LIMBS = 16
MASK = 0xFFFF
DTYPE = torch.int64


# --------------------------------------------------------------------------
# host <-> limb conversion (numpy, host side)
# --------------------------------------------------------------------------

def int_to_limbs(x: int, width: int = LIMBS) -> np.ndarray:
    """Python int -> little-endian 16-bit limb array (host)."""
    if not 0 <= x < (1 << (RADIX_BITS * width)):
        raise ValueError("value does not fit")
    return np.array(
        [(x >> (RADIX_BITS * i)) & MASK for i in range(width)], dtype=np.int64
    )


def limbs_to_int(a) -> int:
    """Limb array (W,) -> Python int (host)."""
    a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
    out = 0
    for i in reversed(range(a.shape[-1])):
        out = (out << RADIX_BITS) | int(a[..., i])
    return out


def ints_to_limbs(xs, width: int = LIMBS) -> np.ndarray:
    """List of ints -> (len, width) limb matrix (host)."""
    return np.stack([int_to_limbs(x, width) for x in xs])


@functools.lru_cache(maxsize=None)
def _dev_const(key: bytes, shape: tuple, device: torch.device) -> torch.Tensor:
    """A cached int64 constant on `device` (never written to)."""
    arr = np.frombuffer(key, dtype=np.int64).reshape(shape)
    return torch.from_numpy(arr.copy()).to(device)


@functools.lru_cache(maxsize=None)
def _int_limbs(x: int) -> np.ndarray:
    return int_to_limbs(x)


def const(x, device, batch_shape=()) -> torch.Tensor:
    """Broadcast a host integer (or limb array) to a batched element."""
    arr = _int_limbs(x) if isinstance(x, int) else np.asarray(x, np.int64)
    t = _dev_const(arr.tobytes(), arr.shape, torch.device(device))
    return t.expand(tuple(batch_shape) + arr.shape)


# --------------------------------------------------------------------------
# Field spec
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class FieldSpec:
    """A prime field GF(m), 2**255 < m < 2**256.

    Fold reduction when K = 2**256 - m < 2**136 (both secp256k1 fields),
    else Barrett (mu_limbs set; the P-256 fields)."""

    name: str
    modulus: int
    m_limbs: np.ndarray = dc_field(repr=False)        # (16,)
    m17_limbs: np.ndarray = dc_field(repr=False)      # (17,) m zero-extended
    k_limbs: np.ndarray = dc_field(repr=False)        # (nk,) K = 2**256 - m
    exp_inv_bits: np.ndarray = dc_field(repr=False)   # (256,) bits of m-2, MSB first
    mu_limbs: np.ndarray | None = dc_field(repr=False, default=None)  # (17,) 2**512 // m

    def __hash__(self):
        return hash((self.name, self.modulus))

    def __eq__(self, other):
        return isinstance(other, FieldSpec) and self.modulus == other.modulus

    @property
    def K(self) -> int:
        return (1 << 256) - self.modulus


@functools.lru_cache(maxsize=None)
def make_spec(name: str, modulus: int) -> FieldSpec:
    K = (1 << 256) - modulus
    if not 0 < K < (1 << 255):
        raise ValueError(f"{name}: the modulus must satisfy 2**255 < m < 2**256")
    nk = (K.bit_length() + RADIX_BITS - 1) // RADIX_BITS
    exp = modulus - 2
    bits = np.array([(exp >> (255 - i)) & 1 for i in range(256)], np.int64)
    # fold reduction would not converge quickly: Barrett
    mu = int_to_limbs((1 << 512) // modulus, 17) if K >= (1 << 136) else None
    return FieldSpec(name=name, modulus=modulus, m_limbs=int_to_limbs(modulus),
                     m17_limbs=int_to_limbs(modulus, LIMBS + 1),
                     k_limbs=int_to_limbs(K, nk), exp_inv_bits=bits,
                     mu_limbs=mu)


def _fast_k0(spec: FieldSpec):
    """k0 if m = 2**256 - 2**32 - k0 with k0 <= 1022, else None: the moduli
    the JAX package's Pallas kernels, and the port's CUDA kernels, are
    written for (secp256k1's base field qualifies, P-256's does not)."""
    k = spec.k_limbs
    if len(k) == 3 and int(k[1]) == 0 and int(k[2]) == 1 and int(k[0]) <= 1022:
        return int(k[0])
    return None


# --------------------------------------------------------------------------
# limb-vector primitives (width-generic, branchless)
# --------------------------------------------------------------------------

def _fit(x, width: int):
    """Cut or zero-extend the limb axis to `width`.  Cutting is exact when the
    caller's value bound is below 2**(16*width): limbs are nonnegative, so a
    nonzero limb above the bound would contradict it."""
    w = x.shape[-1]
    if w >= width:
        return x[..., :width]
    return TF.pad(x, (0, width - w))


def _nlimbs(bound: int) -> int:
    return max(1, (bound.bit_length() + RADIX_BITS - 1) // RADIX_BITS)


def _passes(x, bound: int, carry: bool = False, target: int = 1 << RADIX_BITS):
    """Local carry passes until every limb is <= target (2**16 by default).

    x: nonnegative columns (..., W), each <= bound.  Returns (limbs,
    carry_out) with value = limbs + carry_out * 2**(16W); without `carry`
    the top carry is dropped (the caller's value bound makes it zero).  The
    number of passes follows from the static bound.
    """
    out = torch.zeros_like(x[..., 0]) if carry else None
    while bound > target:
        hi = x >> RADIX_BITS
        if carry:
            out = out + hi[..., -1]
        x = x & MASK
        x[..., 1:] += hi[..., :-1]
        bound = MASK + (bound >> RADIX_BITS)
    return x, out


@functools.lru_cache(maxsize=None)
def _arange(W: int, device: torch.device):
    return torch.arange(W, device=device)


def _propagate(cols, bound: int = (1 << 62)):
    """Carry-propagate nonnegative columns (..., W), each <= bound, into
    16-bit digits.  Returns (digits (..., W), carry_out (...,)).

    Local passes bring every limb to <= 2**16; the remaining 0/1 ripple is
    resolved in one step: the carry out of limb i is the generate bit of the
    last limb at or below i that does not propagate (limb != 0xFFFF).
    """
    x, carry = _passes(cols, bound, carry=True)
    gen = TF.pad(x >> RADIX_BITS, (1, 0))
    last = torch.where(x == MASK, -1, _arange(x.shape[-1], x.device))
    out = torch.gather(gen, -1, last.cummax(dim=-1).values + 1)
    return (x + TF.pad(out[..., :-1], (1, 0))) & MASK, carry + out[..., -1]


def _sub_raw(a, b):
    """a - b over equal-width 16-bit digit vectors -> (digits, borrow 0/1)."""
    u = a + (MASK - b)
    u[..., 0] += 1
    d, c = _propagate(u, 2 * MASK + 1)
    return d, 1 - c


def _mul_cols(a, b):
    """Schoolbook product columns (..., La + Lb - 1) of limb vectors.

    The (La, Lb) outer product is skewed so that row i starts at column i
    (pad each row to La + Lb, then re-read the flat buffer with row length
    La + Lb - 1), and one sum over rows gives every anti-diagonal.
    """
    La, Lb = a.shape[-1], b.shape[-1]
    W = La + Lb
    prod = a.unsqueeze(-1) * b.unsqueeze(-2)                  # (..., La, Lb)
    batch = prod.shape[:-2]
    flat = TF.pad(prod, (0, W - Lb)).reshape(batch + (La * W,))
    skew = flat[..., : La * (W - 1)].reshape(batch + (La, W - 1))
    return skew.sum(dim=-2)


def _mul_raw(a, b):
    """Product digits (..., La + Lb) of normalized limb vectors."""
    cols = _fit(_mul_cols(a, b), a.shape[-1] + b.shape[-1])
    digits, _ = _propagate(cols, min(a.shape[-1], b.shape[-1]) * MASK * MASK)
    return digits


@functools.lru_cache(maxsize=None)
def _spec_consts(spec: FieldSpec, device: torch.device):
    """Per-device constants of a field: K as its own limbs and zero-extended
    to 16 and 17 limbs, and m."""
    def t(arr):
        return torch.as_tensor(arr, dtype=DTYPE).to(device)
    K = spec.K
    return (t(spec.k_limbs), t(int_to_limbs(K, LIMBS)),
            t(int_to_limbs(K, LIMBS + 1)), t(spec.m_limbs))


@functools.lru_cache(maxsize=None)
def _fold_matrix(spec: FieldSpec, device: torch.device):
    """(256, 17) float64 map from the 16x16 limb products to the columns of
    L + H*K, i.e. the product columns with the first fold applied.  For a K
    of at most three limbs; `mul` uses it only where every output column
    stays below 2**53, so the float64 product is exact."""
    R = np.zeros((2 * LIMBS - 1, LIMBS + 1))
    for j in range(2 * LIMBS - 1):
        if j < LIMBS:
            R[j, j] = 1
        else:
            for i, kj in enumerate(spec.k_limbs):
                R[j, j - LIMBS + i] += float(kj)
    M = np.zeros((LIMBS, LIMBS, LIMBS + 1))
    for i in range(LIMBS):
        for j in range(LIMBS):
            M[i, j] = R[i + j]
    return torch.as_tensor(M.reshape(LIMBS * LIMBS, LIMBS + 1)).to(device)


# Barrett's digit bound: two carry passes bring product columns (below
# 17 * 2**32) to at most 2**16 + 16; a third would only trim that overflow.
_LOOSE = (1 << RADIX_BITS) + 32


@functools.lru_cache(maxsize=None)
def _barrett_consts(spec: FieldSpec, device: torch.device):
    """mu = 2**512 // m (17 limbs), and 0, m, 2m, 3m, 4m as 17 limbs, on
    `device`."""
    def t(arr):
        return torch.as_tensor(arr, dtype=DTYPE).to(device)
    return (t(spec.mu_limbs),
            t(np.stack([int_to_limbs(j * spec.modulus, LIMBS + 1)
                        for j in range(5)])))


@functools.lru_cache(maxsize=None)
def _bias(device: torch.device):
    """17 columns 2**38, 2**38 - 2**22, ..., 2**38 - 2**22: each column's
    2**38 is 2**22 of the column above, so they sum to 2**(38 + 256)."""
    b = torch.full((LIMBS + 1,), (1 << 38) - (1 << 22), dtype=DTYPE)
    b[0] = 1 << 38
    return b.to(device)


def _reduce_barrett(spec: FieldSpec, v):
    """Barrett reduction (HAC Alg 14.42, b = 2**16, k = 16) of a value
    v < 2**512 given as nonnegative digits (..., W <= 32), each <= _LOOSE
    (carried but not rippled), mod m > 2**240 (here m > 2**255).

    HAC's q_hat = floor(floor(v / 2**240) * mu / 2**272), mu = 2**512 // m,
    satisfies q - 2 <= q_hat <= q = v // m.  Here both floors are read off
    digits that are carried but not rippled (each <= `_LOOSE`, just over
    2**16, so the digits below a cut stand for less than twice its unit),
    each of which can only undercount by one, so q - 4 <= q_hat <= q and
    r = v - q_hat*m < 5m < 2**259.

    The five candidates r - j*m, j = 0..4, are computed mod 2**272 in one
    stacked carry propagation: the low 17 product columns of q_hat*m (each
    < 2**37) and j*m's limbs are subtracted from v's low 17 digits column
    by column, each column lifted by `_bias` (nonnegative columns below
    2**39; the lifts add up to 0 mod 2**272).  A candidate is negative iff
    its residue is 2**272 minus at most 4m, i.e. its top limb is >= 2**15
    (a nonnegative one is below 5m < 2**259); the answer is the last
    nonnegative one.  Results equal the JAX package's `_reduce_barrett`
    (canonical values).
    """
    mu, mults = _barrett_consts(spec, v.device)
    v = _fit(v, 2 * LIMBS)
    q1 = v[..., LIMBS - 1:]                                       # (..., 17)
    q2, _ = _passes(_fit(_mul_cols(q1, mu.expand(q1.shape)), 2 * LIMBS + 2),
                    (LIMBS + 1) * _LOOSE * MASK, target=_LOOSE)
    q3 = q2[..., LIMBS + 1:]                                      # (..., 17)
    cols = _mul_cols(q3, mults[1, :LIMBS].expand(q3.shape[:-1] + (LIMBS,)))
    r0 = v[..., :LIMBS + 1] - cols[..., :LIMBS + 1] + _bias(v.device)
    cand, _ = _propagate(r0 - mults.reshape((5,) + (1,) * (r0.dim() - 1)
                                            + (LIMBS + 1,)),
                         1 << 39)                                 # mod 2**272
    keep = (cand[..., LIMBS] < (1 << (RADIX_BITS - 1))).sum(0) - 1
    return torch.gather(cand[..., :LIMBS], 0,
                        keep[None, ..., None].expand((1,) + r0.shape[:-1]
                                                     + (LIMBS,)))[0]


def reduce_wide(spec: FieldSpec, v):
    """Reduce normalized digits (..., W >= 16) mod m to canonical (..., 16):
    Barrett for a Barrett modulus (W <= 32), the fold otherwise."""
    return _reduce(spec, v, MASK, (1 << (RADIX_BITS * v.shape[-1])) - 1)


def _reduce(spec: FieldSpec, v, col_bound: int, val_bound: int):
    """Reduce nonnegative columns (..., W) mod m to canonical (..., 16).

    col_bound bounds every column and val_bound the value (static ints).
    A Barrett modulus and a value of 2**272 or more (a product): the
    columns are carried into 32 digits and Barrett reduces them.  Otherwise
    each fold maps H*2**256 + L to L + H*K; once the value is below 2m, one
    conditional subtract finishes: v >= m iff v + K >= 2**256.  (Below
    2**272, H is one limb, and one fold brings even a P-256 value below
    2**256 + 2**240 < 2m: a small-constant mul needs no Barrett.)
    """
    m, K = spec.modulus, spec.K
    if spec.mu_limbs is not None and val_bound >= (1 << 272):
        if val_bound >= (1 << 512):
            raise ValueError("Barrett reduction takes values below 2**512")
        digits, _ = _passes(_fit(v, 2 * LIMBS), col_bound, target=_LOOSE)
        return _reduce_barrett(spec, digits)
    k, _, k17, _ = _spec_consts(spec, v.device)
    nk, kmax = len(spec.k_limbs), int(spec.k_limbs.max())
    while val_bound >= 2 * m:
        v, _ = _passes(_fit(v, _nlimbs(val_bound)), col_bound)
        H = v[..., LIMBS:]
        hk = _mul_cols(H, k.expand(H.shape[:-1] + (nk,)))
        width = max(LIMBS, hk.shape[-1])
        v = _fit(v[..., :LIMBS], width) + _fit(hk, width)
        col_bound = (1 << RADIX_BITS) * (1 + min(H.shape[-1], nk) * kmax)
        val_bound = (1 << 256) - 1 + (val_bound >> 256) * K
    v = _fit(v, LIMBS + 1)
    d, _ = _propagate(torch.stack([v, v + k17]), col_bound + MASK)
    ge = d[1, ..., LIMBS] > 0
    return torch.where(ge.unsqueeze(-1), d[1, ..., :LIMBS], d[0, ..., :LIMBS])


# --------------------------------------------------------------------------
# modular ops (inputs canonical, outputs canonical)
# --------------------------------------------------------------------------

def add(spec: FieldSpec, a, b):
    """(a + b) mod m.  Both candidates, a+b and a+b+K (adding K and dropping
    bit 256 subtracts m), ride one carry propagation; the second lane's
    carry-out is the a+b >= m test."""
    s = a + b
    _, k16, _, _ = _spec_consts(spec, s.device)
    d, c = _propagate(torch.stack(torch.broadcast_tensors(s, s + k16)),
                      3 * MASK)
    return torch.where((c[1] > 0).unsqueeze(-1), d[1], d[0])


def sub(spec: FieldSpec, a, b):
    """(a - b) mod m.  a - b = a + ~b + 1 - 2**256: lane 0 is a - b (valid
    when its carry-out is 1, i.e. a >= b), lane 1 adds m for the wrap."""
    u = a + (MASK - b)
    u[..., 0] += 1
    _, _, _, mm = _spec_consts(spec, u.device)
    d, c = _propagate(torch.stack(torch.broadcast_tensors(u, u + mm)),
                      3 * MASK + 1)
    return torch.where((c[0] > 0).unsqueeze(-1), d[0], d[1])


def neg(spec: FieldSpec, a):
    return sub(spec, torch.zeros_like(a), a)


def mul(spec: FieldSpec, a, b):
    """(a * b) mod m.

    Where K has at most three limbs and the folded columns stay below 2**53
    (the base field: K = 2**32 + 977), the product columns and the first
    fold are one exact float64 matrix product; otherwise the folds run from
    the raw product columns.
    """
    a, b = torch.broadcast_tensors(a, b)
    cb = LIMBS * MASK * MASK * (1 + int(spec.k_limbs.sum()))
    if len(spec.k_limbs) <= 3 and cb < (1 << 53):
        prod = (a.unsqueeze(-1) * b.unsqueeze(-2)).flatten(-2)
        cols = (prod.to(torch.float64) @ _fold_matrix(spec, a.device)).to(DTYPE)
        return _reduce(spec, cols, cb, cb * ((1 << (16 * (LIMBS + 1))) - 1) // MASK)
    return _reduce(spec, _mul_cols(a, b), LIMBS * MASK * MASK,
                   (spec.modulus - 1) ** 2)


def sqr(spec: FieldSpec, a):
    return mul(spec, a, a)


def mul_small(spec: FieldSpec, a, c: int):
    """(a * c) mod m for a small host constant c < 2**16."""
    if not 0 <= c < (1 << RADIX_BITS):
        raise ValueError("mul_small needs 0 <= c < 2**16")
    return _reduce(spec, a * c, MASK * c, (spec.modulus - 1) * c)


def mul_small_vec(spec: FieldSpec, a, consts):
    """Per-slice small-constant mul: a (K, ..., 16) times consts (K,) ints,
    so several small-constant muls share one reduction."""
    cs = [int(c) for c in consts]
    if not all(0 <= c < (1 << RADIX_BITS) for c in cs):
        raise ValueError("mul_small_vec needs 0 <= c < 2**16")
    c = const(np.asarray(cs, np.int64), a.device).reshape(
        (len(cs),) + (1,) * (a.dim() - 1))
    cmax = max(cs)
    return _reduce(spec, a * c, MASK * cmax, (spec.modulus - 1) * cmax)


def pow_const(spec: FieldSpec, a, exp_bits):
    """a ** e mod m for a fixed exponent given as an MSB-first bit array
    (host constant; length a multiple of 4).

    Fixed 4-bit windows, as the JAX package: a table a^0..a^15, then per
    window 4 squarings and one table mul.  The exponent is public, so the
    window digit indexes the table directly.
    """
    ebits = np.asarray(exp_bits)
    if ebits.ndim != 1 or ebits.shape[0] % 4:
        raise ValueError("exponent bits must be a 1-d array, length % 4 == 0")
    digs = [int(ebits[i] * 8 + ebits[i + 1] * 4 + ebits[i + 2] * 2
                + ebits[i + 3]) for i in range(0, ebits.shape[0], 4)]
    one = const(1, a.device, a.shape[:-1])
    tab = [one, a]
    for _ in range(2, 16):
        tab.append(mul(spec, tab[-1], a))
    acc = one
    for d in digs:
        for _ in range(4):
            acc = mul(spec, acc, acc)
        acc = mul(spec, acc, tab[d])
    return acc


def inv(spec: FieldSpec, a):
    """a**-1 mod m via Fermat (a**(m-2)); inv(0) = 0."""
    return pow_const(spec, a, spec.exp_inv_bits)


def is_zero(a):
    return (a == 0).all(dim=-1)


def eq(a, b):
    return (a == b).all(dim=-1)


def select(cond, a, b):
    """Elementwise select: cond (...,) bool -> limbs."""
    return torch.where(cond.unsqueeze(-1), a, b)


# --------------------------------------------------------------------------
# randomness
# --------------------------------------------------------------------------

def random_words(spec: FieldSpec) -> int:
    """Random 32-bit words a field element takes: 8, or 16 for a Barrett
    modulus (its 512-bit value is reduced, bias < 2**-256)."""
    return 8 if spec.mu_limbs is None else 16


def from_random_bits(spec: FieldSpec, bits32):
    """32-bit random words (..., 8 or 16), as int64 in [0, 2**32) -> field
    element.

    8 words: values in [m, 2**256) wrap once; for m within 2**136 of 2**256
    the statistical distance from uniform is < 2**-120.  16 words: the
    512-bit value is reduced mod m.  This is the port's randomness seam:
    tests hand both packages the same words.
    """
    words = bits32.shape[-1]
    if words not in (8, 16):
        raise ValueError("a field element takes 8 or 16 random words")
    limbs = torch.stack([bits32 & MASK, bits32 >> RADIX_BITS], dim=-1)
    v = limbs.reshape(bits32.shape[:-1] + (2 * words,))
    return _reduce(spec, v, MASK, (1 << (32 * words)) - 1)


class Rows(NamedTuple):
    """One rank's rows of every draw over all `total` bidders (the bidder
    mesh, `parallel/mesh.py`).  Given as `random`'s generator, the draw is
    made at the unsharded shape and the rank keeps `rows`: it takes from
    `generator` what the unsharded driver takes, and its lanes get the
    values the unsharded driver's lanes get."""

    generator: torch.Generator
    rows: slice
    total: int


def draw_words(spec: FieldSpec, generator, shape=(), bidder_dim: int = 1):
    """The random words `random` reduces for `shape`: (*shape,
    random_words(spec)) int64 in [0, 2**32), drawn from `generator` and left
    on its device.  With `Rows` of a generator, shape[bidder_dim] is the
    rank's row count: the draw is made with `total` there and the rows
    kept."""
    if isinstance(generator, Rows):
        shape, rows = tuple(shape), generator.rows
        if shape[bidder_dim] != rows.stop - rows.start:
            raise ValueError(f"random: dim {bidder_dim} of {shape} is not the "
                             f"rank's {rows.stop - rows.start} bidder rows")
        full = shape[:bidder_dim] + (generator.total,) + shape[bidder_dim + 1:]
        return draw_words(spec, generator.generator, full).narrow(
            bidder_dim, rows.start, rows.stop - rows.start)
    return torch.randint(0, 1 << 32, tuple(shape) + (random_words(spec),),
                         generator=generator, dtype=DTYPE,
                         device=generator.device)


def random(spec: FieldSpec, generator, shape=(), device=None,
           bidder_dim: int = 1):
    """Uniform field elements: `random_words(spec)` words each, drawn from
    `generator` on its own device (`draw_words`), then moved to `device`
    (default: the generator's), so one seeded CPU generator gives the same
    elements on every device."""
    words = draw_words(spec, generator, shape, bidder_dim)
    return from_random_bits(spec, words.to(device or words.device))


# --------------------------------------------------------------------------
# byte serialization (big-endian, SEC1-compatible coordinate encoding)
# --------------------------------------------------------------------------

def to_bytes_be(a):
    """Field element (..., 16) -> big-endian bytes (..., 32) uint8."""
    limbs_be = a.flip(-1)
    inter = torch.stack([limbs_be >> 8, limbs_be & 0xFF], dim=-1)
    return inter.reshape(a.shape[:-1] + (32,)).to(torch.uint8)


def from_bytes_be(b):
    """Big-endian bytes (..., 32) uint8 -> limbs (..., 16) int64."""
    b = b.to(DTYPE).reshape(b.shape[:-1] + (LIMBS, 2))
    return ((b[..., 0] << 8) | b[..., 1]).flip(-1)
