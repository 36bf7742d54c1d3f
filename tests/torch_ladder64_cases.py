"""Shared cases of the tests of the 64-window ladders and the single add
(tests/test_torch_ec_*64.py): the port's plain versions against the golden
vectors that tools/torch_golden.py wrote from the JAX package
(tests/data/torch_golden_ladders64.npz) -- the TPU kernels in Pallas
interpret mode and the JAX package's XLA ladders for a curve without GLV --
and against `host_curve`.  The lanes are the kernel validator's edge lanes:
scalars 0, 1 and n-1, a point at infinity, and one random lane."""

import dataclasses
import pathlib

import numpy as np
import torch

from privacy_auction_tpu_torch import interop
from privacy_auction_tpu_torch.curves import SECP256K1 as C
from privacy_auction_tpu_torch.ops import ec
from privacy_auction_tpu_torch.ops import field as F

GOLD = np.load(pathlib.Path(__file__).resolve().parent / "data"
               / "torch_golden_ladders64.npz")
HOST = C.host
# secp256k1 without its GLV parameters: the protocols' ladders then take
# their 64-window forms, as the JAX package's do on such a curve
NO_GLV = dataclasses.replace(C, name="secp256k1-without-glv")
NO_GLV.__dict__["glv"] = None


def g(name, device="cpu"):
    return interop.to_torch(GOLD[name], device=device)


def _ints(t):
    return [F.limbs_to_int(row) for row in t]


def _pts(t):
    return [ec.decode_host_point(C, p) for p in t]


def _mul(k, P):
    return None if P is None else HOST.mul(k, P)


def want(name):
    """The host oracle's affine points for a ladder of the golden lanes."""
    ks, ts, Ps, Qs = _ints(g("k")), _ints(g("t")), _pts(g("P")), _pts(g("Q"))
    if name == "scalar_mul":
        return [_mul(k, P) for k, P in zip(ks, Ps)]
    if name == "dual_mul":
        return [HOST.add(_mul(k, P), _mul(t, Q))
                for k, P, t, Q in zip(ks, Ps, ts, Qs)]
    if name == "base_mul_add":
        return [HOST.add(HOST.mul(k, HOST.g), _mul(t, P))
                for k, P, t in zip(ks, Ps, ts)]
    return [HOST.add(a, b) for a, b in zip(_pts(g("add.P")), _pts(g("add.Q")))]


def check(name, out):
    """`out` equals the Pallas interpret output and the XLA ladder limb for
    limb, and the host oracle in affine coordinates."""
    out = out.cpu()
    for ref in ("pallas", "xla"):
        np.testing.assert_array_equal(out.numpy(), GOLD[f"{ref}.{name}"]
                                      .astype(np.int64), err_msg=ref)
    assert _pts(out) == want(name)


def same(a, b):
    assert torch.equal(a, b)
