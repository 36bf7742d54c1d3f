"""NIST P-256 on the port's generic plain path (RCB16 Algorithms 1 and 3,
the 64-window ladders without GLV; `privacy_auction_tpu_torch/ops/ec.py`)
as projective limbs against the JAX package's pure path
(tests/data/torch_golden_p256.npz, from tools/torch_golden.py) and as
points against the host oracle: `add` and `dbl` with infinity, P + P and
P + (-P) lanes, `scalar_mul`, `mul_base`, `dual_mul` and `base_mul_add` at
k = 0, 1, n - 1 and seeded scalars, with infinity inputs; and the generic
`on_curve`.  Tolerance 0."""

import pathlib

import numpy as np
import torch

from privacy_auction_tpu_torch.curves import get_curve
from privacy_auction_tpu_torch.ops import ec
from privacy_auction_tpu_torch.ops import field as F

torch.set_num_threads(1)

GOLD = np.load(pathlib.Path(__file__).resolve().parent / "data"
               / "torch_golden_p256.npz")
CURVE = get_curve("P-256")
HOST = CURVE.host


def _t(name):
    return torch.as_tensor(GOLD[f"ec.{name}"].astype(np.int64))


def _host(P):
    return [ec.decode_host_point(CURVE, p) for p in P]


def _check(name, got, want_points):
    np.testing.assert_array_equal(got.numpy(), _t(name).numpy(), err_msg=name)
    assert _host(got) == want_points, name


def test_p256_point_ops_match_jax_and_host():
    assert not CURVE.a_is_zero and CURVE.glv is None and CURVE.b3 == 0
    assert not ec.kernel_curve(CURVE)
    P, Q = _t("add.P"), _t("add.Q")
    ps, qs = _host(P), _host(Q)
    _check("add", ec.add(CURVE, P, Q), [HOST.add(p, q) for p, q in zip(ps, qs)])
    _check("dbl", ec.dbl(CURVE, P), [HOST.add(p, p) for p in ps])
    assert bool(ec.on_curve(CURVE, P).all())
    bad = P.clone()
    bad[0, 0, 0] ^= 1
    assert not bool(ec.on_curve(CURVE, bad)[0])

    k, t = _t("k"), _t("t")
    ks = [F.limbs_to_int(r) for r in k]
    ts = [F.limbs_to_int(r) for r in t]
    base, other = _t("base"), _t("other")
    bs, os_ = _host(base), _host(other)
    _check("scalar_mul", ec.scalar_mul(CURVE, base, k),
           [HOST.mul(a, b) for a, b in zip(ks, bs)])
    _check("mul_base", ec.mul_base(CURVE, k), [HOST.mul(a, HOST.g) for a in ks])
    _check("dual_mul", ec.dual_mul(CURVE, base, k, other, t),
           [HOST.add(HOST.mul(a, b), HOST.mul(c, d))
            for a, b, c, d in zip(ks, bs, ts, os_)])
    _check("base_mul_add", ec.base_mul_add(CURVE, k, base, t),
           [HOST.add(HOST.mul(a, HOST.g), HOST.mul(c, b))
            for a, b, c in zip(ks, bs, ts)])
