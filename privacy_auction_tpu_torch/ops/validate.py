"""Differential validation of the EC kernels against the host oracle.

Counterpart of `privacy_auction_tpu/ops/validate.py`
(`validate_pallas_kernels`), in the same order:

1. the direct ladders on the given curve, as the JAX validator calls the
   Pallas wrappers: `scalar_mul_windows` (scalar kernel, 64 windows),
   `dual_mul_windows` at 64 windows on full scalars, `base_mul_add_windows`
   (the ladder without GLV) and `mul_base` (comb kernel);
2. on a GLV curve, the GLV dispatch that the protocols run: `scalar_mul`
   (dual kernel, 33 windows), `dual_mul` (quad kernel) and `base_mul_add`
   (GLV base kernel);
3. `pt_add` (one complete add) on the lanes P+Q, P+P, P+(-P) and P+inf.

Every lane is held against the pure-int `host_curve`, including the edge
lanes: scalar 0, scalar 1, scalar n-1 and a point at infinity.  On a CUDA
device this checks the kernels, on the CPU their plain versions.  Run it
before any timing on the card.
"""

from __future__ import annotations

import random

import torch

from ..curves import COMB_WINDOWS, Curve
from . import ec
from . import field as F


class ValidationError(RuntimeError):
    pass


def _decode(curve: Curve, arr):
    return [ec.decode_host_point(curve, p) for p in arr.cpu()]


def validate_kernels(curve: Curve, lanes: int = 8, seed: int = 0,
                     device="cuda") -> None:
    """Raise ValidationError on any mismatch with the host oracle."""
    if lanes < 4:
        raise ValueError("validate_kernels needs at least 4 lanes")
    host = curve.host
    rng = random.Random(seed)
    ks = [0, 1, host.n - 1] + [rng.randrange(host.n) for _ in range(lanes - 3)]
    ts = [1, 0, rng.randrange(host.n)] + [rng.randrange(host.n)
                                          for _ in range(lanes - 3)]
    bases = [rng.randrange(1, host.n) for _ in range(lanes)]
    P_host = [host.mul(b, host.g) for b in bases]
    Q_host = [host.mul(b + 1, host.g) for b in bases]
    P_host[2] = None          # the point-at-infinity input lane
    Q_host[2] = None

    k = torch.as_tensor(F.ints_to_limbs(ks)).to(device)
    t = torch.as_tensor(F.ints_to_limbs(ts)).to(device)
    P = ec.encode_host_points(P_host, device)
    Q = ec.encode_host_points(Q_host, device)

    def mul(a, B):
        return host.mul(a, B) if B is not None else None

    want_sm = [mul(a, B) for a, B in zip(ks, P_host)]
    want_dm = [host.add(mul(a, B), mul(b, C))
               for a, B, b, C in zip(ks, P_host, ts, Q_host)]
    want_bma = [host.add(host.mul(a, host.g), mul(b, B))
                for a, B, b in zip(ks, P_host, ts)]
    checks = {
        "scalar_mul (64 windows)": (
            lambda: ec.scalar_mul_windows(curve, P, k, COMB_WINDOWS), want_sm),
        "dual_mul (64 windows)": (
            lambda: ec.dual_mul_windows(curve, P, k, Q, t, COMB_WINDOWS),
            want_dm),
        "base_mul_add (64 windows)": (
            lambda: ec.base_mul_add_windows(curve, k, P, t),
            want_bma),
        "mul_base": (lambda: ec.mul_base(curve, k),
                     [host.mul(a, host.g) for a in ks]),
    }
    if curve.glv is not None:
        checks.update({
            "GLV scalar_mul": (lambda: ec.scalar_mul(curve, P, k), want_sm),
            "GLV dual_mul": (lambda: ec.dual_mul(curve, P, k, Q, t), want_dm),
            "GLV base_mul_add": (lambda: ec.base_mul_add(curve, k, P, t),
                                 want_bma),
        })
    # pt_add lanes: P+Q, P+P, P+(-P), P+inf, inf+Q (lane 2 of P is inf)
    A = P[[0, 1, 3, 0, 2]]
    B = P[[0, 1, 3, 2, 2]].clone()
    B[0] = Q[0]
    B[2] = ec.neg(curve, P[3])
    B[4] = Q[1]
    a_host = [P_host[i] for i in (0, 1, 3, 0, 2)]
    b_host = [Q_host[0], P_host[1], host.neg(P_host[3]), None, Q_host[1]]
    checks["pt_add"] = (lambda: ec.pt_add(curve, A, B),
                        [host.add(a, b) for a, b in zip(a_host, b_host)])

    for name, (run, want) in checks.items():
        got = _decode(curve, run())
        if got != want:
            bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
            raise ValidationError(f"{name} on {device}: lanes {bad} disagree "
                                  f"with the host oracle")
