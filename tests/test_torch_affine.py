"""The projective-to-affine conversion (`ec.to_affine`) on the CPU: the
kernel's addition chain for p - 2 (tests/torch_inv_chain.py) against
Python's pow, the kernel's device functions compiled for the host against
the plain version, and the dispatch: a CPU tensor and a P-256 tensor take
the plain version, a secp256k1 tensor off the CPU reaches the kernel's
wrapper.  On a card, tests/test_torch_affine_cuda.py holds the kernel
itself to the plain version."""

import random

import numpy as np
import pytest
import torch

from privacy_auction_tpu_torch.curves import SECP256K1 as C, get_curve
from privacy_auction_tpu_torch.ops import cuda_ec, ec
from privacy_auction_tpu_torch.ops import field as F

from torch_inv_chain import chain_exponent, host_library, inv_chain

P = C.host.p
EDGES = (0, 1, 2, P - 1, P - 2)


def test_inv_chain_is_fermat_inverse():
    """The chain reaches a^(p-2) in 255 squarings and 15 multiplications,
    and gives pow(a, p - 2, p) on the edge values and 300 seeded ones."""
    assert chain_exponent() == P - 2
    rng = random.Random(16)
    for a in EDGES + tuple(rng.randrange(P) for _ in range(300)):
        got, squarings, muls = inv_chain(a, P)
        assert (squarings, muls) == (255, 15)
        assert got == pow(a, P - 2, P), a


def _limbs(xs):
    return np.ascontiguousarray(F.ints_to_limbs(xs))


def _ints(limbs):
    return [F.limbs_to_int(r) for r in limbs]


def _points(rng, n):
    """n projective points: on the curve (x from the seed, y its square
    root) scaled by a random Z, then the edge lanes: Z = 1, Z = p - 1,
    infinity (0:1:0), and a Z = 0 lane with X, Y set."""
    pts = []
    while len(pts) < n:
        x = rng.randrange(P)
        y = pow(x ** 3 + 7, (P + 1) // 4, P)
        if y * y % P == (x ** 3 + 7) % P:
            z = rng.randrange(1, P)
            pts.append((x * z % P, y * z % P, z))
    pts[0] = (pts[0][0] * pow(pts[0][2], P - 2, P) % P,
              pts[0][1] * pow(pts[0][2], P - 2, P) % P, 1)
    pts[1] = (P - pts[1][0], pts[1][1], P - 1)
    pts[2] = (0, 1, 0)
    pts[3] = (pts[3][0], pts[3][1], 0)
    return pts


def test_kernel_source_matches_plain_on_the_host(tmp_path):
    """The kernel's field functions and its lane, compiled for the host:
    the squaring equals the product of a value with itself and Python's,
    the inversion pow(a, p - 2, p), and a lane's (x, y) the plain
    `ec.to_affine_plain` limb for limb, infinity (0, 0)."""
    dll = host_library(tmp_path)
    rng = random.Random(17)
    xs = list(EDGES) + [rng.randrange(P) for _ in range(200)]
    a = _limbs(xs)
    out, prod = np.zeros_like(a), np.zeros_like(a)
    dll.sqr(a.ctypes.data, out.ctypes.data, len(xs))
    dll.mul(a.ctypes.data, a.ctypes.data, prod.ctypes.data, len(xs))
    assert _ints(out) == [x * x % P for x in xs]
    np.testing.assert_array_equal(out, prod)
    dll.inv(a.ctypes.data, out.ctypes.data, len(xs))
    assert _ints(out) == [pow(x, P - 2, P) for x in xs]

    pts = _points(rng, 64)
    host = np.ascontiguousarray(np.stack([_limbs(p) for p in pts]))
    got = np.zeros((len(pts), 2, 16), dtype=np.int64)
    dll.to_affine(host.ctypes.data, got.ctypes.data, len(pts))
    x, y = ec.to_affine_plain(C, torch.from_numpy(host))
    np.testing.assert_array_equal(got, torch.stack([x, y], dim=-2).numpy())
    for (X, Y, Z), (gx, gy) in zip(pts, got):
        zi = pow(Z, P - 2, P)
        assert _ints([gx, gy]) == [X * zi % P, Y * zi % P]
    assert not got[2:4].any()


def test_to_affine_dispatch_goes_by_device_and_curve():
    """A CPU tensor takes the plain version on either curve; off the CPU
    ("meta" here, "cuda" on a card) a secp256k1 tensor reaches the kernel's
    wrapper, with no fallback (the wrapper here records its call and
    raises), and a P-256 tensor takes the plain version; the wrapper
    refuses P-256 and a CPU tensor."""
    P256 = get_curve("P-256")
    calls = []

    def spy(kind):
        def f(curve, pts):
            calls.append((kind, curve.name, pts.device.type))
            if kind == "kernel":
                raise RuntimeError("no card")
            return pts[..., 0, :], pts[..., 1, :]
        return f

    cpu = torch.zeros((2, 5, 3, 16), dtype=torch.int64)
    meta = cpu.to("meta")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ec, "to_affine_plain", spy("plain"))
        mp.setattr(cuda_ec, "to_affine", spy("kernel"))
        for curve in (C, P256):
            ec.to_affine(curve, cpu)
        ec.to_affine(P256, meta)
        with pytest.raises(RuntimeError, match="no card"):
            ec.to_affine(C, meta)
    assert calls == [("plain", C.name, "cpu"), ("plain", P256.name, "cpu"),
                     ("plain", P256.name, "meta"), ("kernel", C.name, "meta")]
    with pytest.raises(ValueError, match="written for secp256k1"):
        cuda_ec.to_affine(P256, cpu)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ec.to_affine(C, cpu)
    # the counter row is apart from the EC rows that mirror the Pallas
    # kernels
    assert cuda_ec.AFFINE in cuda_ec.launches
    assert cuda_ec.AFFINE not in cuda_ec.EC_ROWS + cuda_ec.KERNELS
