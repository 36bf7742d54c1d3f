"""Curve registry of the PyTorch port: secp256k1 and NIST P-256.

Counterpart of `privacy_auction_tpu/curves.py`.  Curve constants, the
fixed-base comb table of the generator and the GLV parameters all come from
exact host integers, so they equal the JAX package's arrays limb for limb.
secp256k1 (a = 0, fold-reduced fields, GLV) is the curve the CUDA kernels
are written for; P-256 (a != 0, Barrett-reduced fields, no GLV) runs the
generic plain path on any device, as it runs the JAX package's pure-XLA
path.  `get_curve("P-256")` (or "p256", the JAX package's name) gives it.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field as dc_field

import numpy as np
import torch

from .ops import field as F
from .utils.host_curve import HOST_CURVES, HostCurve

COMB_WINDOW = 4                      # bits per comb window
COMB_WINDOWS = 256 // COMB_WINDOW    # 64 windows
COMB_SIZE = 1 << COMB_WINDOW         # 16 table entries per window

GLV_SHIFT = 272           # rounding-division shift (k*g >> 272)
GLV_WINDOWS = 33          # 4-bit windows covering |k_i| < 2**132


@dataclass(frozen=True)
class Curve:
    """A short-Weierstrass curve y^2 = x^3 + a*x + b prepared for the port."""

    name: str
    host: HostCurve = dc_field(repr=False)
    fp: F.FieldSpec = dc_field(repr=False)   # base field GF(p)
    fn: F.FieldSpec = dc_field(repr=False)   # scalar field GF(n)
    b3: int = 0                              # 3*b (a = 0 formulas), else 0

    def __hash__(self):
        return hash(self.name)

    def __eq__(self, other):
        return isinstance(other, Curve) and self.name == other.name

    @property
    def a_is_zero(self) -> bool:
        """a == 0 selects the RCB16 Alg 7/9 formulas (and, with a fold
        modulus, the CUDA kernels); otherwise the generic Alg 1/3 run."""
        return self.host.a == 0

    @functools.cached_property
    def a_limbs(self) -> np.ndarray:
        """(16,) a mod p as a field element (generic formulas)."""
        return F.int_to_limbs(self.host.a % self.host.p)

    @functools.cached_property
    def b_limbs(self) -> np.ndarray:
        return F.int_to_limbs(self.host.b % self.host.p)

    @functools.cached_property
    def b3_limbs(self) -> np.ndarray:
        """(16,) 3*b mod p as a full field element (generic formulas; P-256's
        b is full-width, so the small-constant form cannot apply)."""
        return F.int_to_limbs(3 * self.host.b % self.host.p)

    @functools.cached_property
    def generator_affine(self) -> np.ndarray:
        """(2, 16) limbs: generator (x, y)."""
        return np.stack(
            [F.int_to_limbs(self.host.gx), F.int_to_limbs(self.host.gy)]
        )

    @functools.cached_property
    def comb_table(self) -> np.ndarray:
        """(COMB_WINDOWS, COMB_SIZE, 3, 16): entry [w][d] is d * 2**(4w) * G
        with Z = 1 (digit 0 = infinity (0:1:0))."""
        return make_comb_table(self.host, self.host.g)

    @functools.cached_property
    def glv(self) -> "GlvParams | None":
        """GLV endomorphism parameters, or None for a curve without the
        endomorphism (the ladders then take their 64-window forms)."""
        return derive_glv_params(self.host)

    @functools.cached_property
    def g0_table(self) -> np.ndarray:
        """(16, 3, 16): window-0 comb entries d*G (Z = 1), the constant
        table of the `base_mul_add` ladder without GLV."""
        return np.array(self.comb_table[0])

    @functools.cached_property
    def g0_tables(self) -> np.ndarray:
        """(2, 16, 3, 16): window-0 comb entries d*G and d*phi(G) (Z = 1),
        the constant tables of the GLV `base_mul_add`."""
        t = self.g0_table
        tl = t.copy()
        for d in range(1, COMB_SIZE):
            x = F.limbs_to_int(t[d, 0])
            tl[d, 0] = F.int_to_limbs(x * self.glv.beta % self.host.p)
        return np.stack([t, tl])

    def tensor(self, name: str, device) -> torch.Tensor:
        """A host constant of this curve as a cached int64 tensor on `device`
        (never written to)."""
        return _curve_tensor(self, name, torch.device(device))


@functools.lru_cache(maxsize=None)
def _curve_tensor(curve: Curve, name: str, device: torch.device):
    return torch.as_tensor(getattr(curve, name), dtype=F.DTYPE).to(device)


@dataclass(frozen=True)
class GlvParams:
    """Host-derived GLV decomposition constants (verified at derivation).

    phi(x, y) = (beta*x, y) equals scalar multiplication by lam; k*P is
    computed as k1*P + k2*phi(P) with |k1|, |k2| < 2**132.
    """

    lam: int
    beta: int
    n: int
    a1: int
    b1: int
    a2: int
    b2: int
    g1: int
    g2: int
    beta_limbs: np.ndarray = dc_field(repr=False)
    a1n_limbs: np.ndarray = dc_field(repr=False)
    a2n_limbs: np.ndarray = dc_field(repr=False)
    b1n_limbs: np.ndarray = dc_field(repr=False)
    b2n_limbs: np.ndarray = dc_field(repr=False)
    g1_limbs: np.ndarray = dc_field(repr=False)   # (10,)
    g2_limbs: np.ndarray = dc_field(repr=False)

    def decompose_host(self, k: int):
        """Exact-int decomposition (test oracle): (k1, k2) signed with
        k1 + k2*lam = k mod n."""
        c1 = _round_div(self.b2 * k, self.n)
        c2 = _round_div(-self.b1 * k, self.n)
        k1 = k - c1 * self.a1 - c2 * self.a2
        k2 = -c1 * self.b1 - c2 * self.b2
        return k1, k2


def _round_div(a: int, b: int) -> int:
    """round(a / b) for b > 0, exact."""
    return (2 * a + b) // (2 * b)


def derive_glv_params(host: HostCurve) -> GlvParams | None:
    """GLV constants for an a=0 curve with p = n = 1 mod 3, from first
    principles (order-3 elements, a short lattice basis by the truncated
    extended Euclid of GECC Alg 3.74, rounding multipliers 2**272*|b|/n);
    None for any other curve."""
    p, n = host.p, host.n
    if host.a != 0 or p % 3 != 1 or n % 3 != 1:
        return None

    def order3(m):
        for x in range(2, 100):
            c = pow(x, (m - 1) // 3, m)
            if c != 1:
                return c
        raise RuntimeError("no order-3 element found")

    lam = order3(n)
    beta = order3(p)
    target = host.mul(lam, host.g)
    if target != (beta * host.gx % p, host.gy):
        beta = beta * beta % p
        if target != (beta * host.gx % p, host.gy):
            raise RuntimeError("beta/lam mismatch")

    rs = [n, lam]
    ts = [0, 1]
    while rs[-1] ** 2 >= n:
        q = rs[-2] // rs[-1]
        rs.append(rs[-2] - q * rs[-1])
        ts.append(ts[-2] - q * ts[-1])
    a1, b1 = rs[-1], -ts[-1]
    cand_prev = (rs[-2], -ts[-2])
    q = rs[-2] // rs[-1]
    cand_next = (rs[-2] - q * rs[-1], -(ts[-2] - q * ts[-1]))
    a2, b2 = min(cand_prev, cand_next, key=lambda v: v[0] * v[0] + v[1] * v[1])
    for (ai, bi) in ((a1, b1), (a2, b2)):
        if (ai + bi * lam) % n or abs(ai) >= (1 << 129) or abs(bi) >= (1 << 129):
            raise RuntimeError("lattice basis invariant")

    g1 = _round_div((1 << GLV_SHIFT) * b2, n)
    g2 = _round_div((1 << GLV_SHIFT) * -b1, n)
    params = GlvParams(
        lam=lam, beta=beta, n=n, a1=a1, b1=b1, a2=a2, b2=b2, g1=g1, g2=g2,
        beta_limbs=F.int_to_limbs(beta),
        a1n_limbs=F.int_to_limbs(a1 % n),
        a2n_limbs=F.int_to_limbs(a2 % n),
        b1n_limbs=F.int_to_limbs(b1 % n),
        b2n_limbs=F.int_to_limbs(b2 % n),
        g1_limbs=F.int_to_limbs(g1, 10),
        g2_limbs=F.int_to_limbs(g2, 10),
    )
    for k in (0, 1, n - 1, 0xDEADBEEF, (1 << 255) - 19):
        k1, k2 = params.decompose_host(k)
        if (k1 + k2 * lam - k) % n or max(abs(k1), abs(k2)) >= (1 << 132):
            raise RuntimeError("decomposition identity")
    return params


def make_comb_table(host: HostCurve, base_affine) -> np.ndarray:
    """Host-side comb table for an arbitrary base point (affine int pair)."""
    out = np.zeros((COMB_WINDOWS, COMB_SIZE, 3, F.LIMBS), dtype=np.int64)
    base = base_affine
    for w in range(COMB_WINDOWS):
        out[w, 0] = encode_host_point(None)
        acc = None
        for d in range(1, COMB_SIZE):
            acc = host.add(acc, base)
            out[w, d] = encode_host_point(acc)
        for _ in range(COMB_WINDOW):
            base = host.add(base, base)
    return out


def encode_host_point(P) -> np.ndarray:
    """Affine host point (or None = infinity) -> (3, 16) projective limbs."""
    if P is None:
        return np.stack([F.int_to_limbs(0), F.int_to_limbs(1), F.int_to_limbs(0)])
    x, y = P
    return np.stack([F.int_to_limbs(x), F.int_to_limbs(y), F.int_to_limbs(1)])


# other names of the registry's curves
ALIASES = {"P-256": "p256", "secp256r1": "p256"}


def get_curve(name: str = "secp256k1") -> Curve:
    """The curve of that name: "secp256k1", or P-256 as "P-256", "p256"
    or "secp256r1" (one Curve object, named "p256" as in the JAX package)."""
    return _make_curve(ALIASES.get(name, name))


@functools.lru_cache(maxsize=None)
def _make_curve(name: str) -> Curve:
    if name not in HOST_CURVES:
        raise ValueError(f"unknown curve {name!r}; known: "
                         f"{sorted(HOST_CURVES) + sorted(ALIASES)}")
    host = HOST_CURVES[name]
    return Curve(
        name=name,
        host=host,
        fp=F.make_spec(f"{name}_p", host.p),
        fn=F.make_spec(f"{name}_n", host.n),
        b3=3 * host.b if host.a == 0 else 0,
    )


SECP256K1 = get_curve("secp256k1")
