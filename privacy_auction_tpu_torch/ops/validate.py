"""Differential validation of the EC ladders against the host oracle.

Counterpart of `privacy_auction_tpu/ops/validate.py`.  Runs the four
ladders of the protocols' path through the GLV dispatch of `ops.ec` --
`mul_base` (comb kernel), `scalar_mul` (dual kernel, 33 windows),
`dual_mul` (quad kernel) and `base_mul_add` (GLV base kernel) -- on the
given device, and holds every lane against the pure-int `host_curve`,
including the edge lanes: scalar 0, scalar 1, scalar n-1 and a point at
infinity.  On a CUDA device this checks the kernels, on the CPU their plain
versions.  Run it before any timing on the card.
"""

from __future__ import annotations

import random

import torch

from ..curves import Curve
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

    checks = {
        "mul_base": (ec.mul_base(curve, k),
                     [host.mul(a, host.g) for a in ks]),
        "scalar_mul": (ec.scalar_mul(curve, P, k),
                       [mul(a, B) for a, B in zip(ks, P_host)]),
        "dual_mul": (ec.dual_mul(curve, P, k, Q, t),
                     [host.add(mul(a, B), mul(b, C))
                      for a, B, b, C in zip(ks, P_host, ts, Q_host)]),
        "base_mul_add": (ec.base_mul_add(curve, k, P, t),
                         [host.add(host.mul(a, host.g), mul(b, B))
                          for a, B, b in zip(ks, P_host, ts)]),
    }
    for name, (got, want) in checks.items():
        got = _decode(curve, got)
        if got != want:
            bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
            raise ValidationError(f"{name} on {device}: lanes {bad} disagree "
                                  f"with the host oracle")
