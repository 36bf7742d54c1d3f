"""Shared cases of the port-vs-JAX EC ladder tests (tests/test_torch_ec*.py).

Each ladder function of the PyTorch port's plain path runs on the same
inputs as the JAX package's `ec.*` on the CPU (its XLA path, the reference
that tests/test_pallas_*.py pin the TPU kernels to) and as `host_curve`.
The lanes are the edge lanes of `privacy_auction_tpu/ops/validate.py`:
scalars 0, 1 and n-1, a point at infinity, and one random lane.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import torch

from privacy_auction_tpu.curves import SECP256K1 as JC
from privacy_auction_tpu.ops import ec as JE
from privacy_auction_tpu.ops import field as JF
from privacy_auction_tpu_torch.curves import SECP256K1 as TC
from privacy_auction_tpu_torch.ops import ec as TE

HOST = TC.host


def edge_inputs(seed=3):
    rng = random.Random(seed)
    n = HOST.n
    ks = [0, 1, n - 1, rng.randrange(n)]
    ts = [1, 0, rng.randrange(n), rng.randrange(n)]
    P = [HOST.mul(rng.randrange(1, n), HOST.g) for _ in range(4)]
    Q = [HOST.mul(rng.randrange(1, n), HOST.g) for _ in range(4)]
    P[2] = Q[2] = None
    return ks, ts, P, Q


def _both(ints_or_points, points=False):
    arr = (JE.encode_host_points(ints_or_points) if points
           else JF.ints_to_limbs(ints_or_points))
    return jnp.asarray(arr), torch.as_tensor(np.asarray(arr).astype(np.int64))


def _m(k, P):
    return None if P is None else HOST.mul(k, P)


LADDERS = {
    # name: (jax fn, port fn, host oracle, same projective formulas?)
    "mul_base": (lambda C, E, k, t, P, Q: E.mul_base(C, k),
                 lambda k, t, P, Q: HOST.mul(k, HOST.g), True),
    "scalar_mul": (lambda C, E, k, t, P, Q: E.scalar_mul(C, P, k),
                   lambda k, t, P, Q: _m(k, P), True),
    "dual_mul": (lambda C, E, k, t, P, Q: E.dual_mul(C, P, k, Q, t),
                 lambda k, t, P, Q: HOST.add(_m(k, P), _m(t, Q)), True),
    # the JAX XLA path builds its generator table from +-G, the port (as the
    # TPU kernel) reads affine comb entries: equal as points only
    "base_mul_add": (lambda C, E, k, t, P, Q: E.base_mul_add(C, k, P, t),
                     lambda k, t, P, Q: HOST.add(HOST.mul(k, HOST.g), _m(t, P)),
                     False),
}


def check_ladder(name):
    ks, ts, Ps, Qs = edge_inputs()
    (jk, tk), (jt, tt) = _both(ks), _both(ts)
    (jP, tP), (jQ, tQ) = _both(Ps, True), _both(Qs, True)
    jfn, want_fn, same_formulas = LADDERS[name]
    jout = np.asarray(jax.jit(lambda k, t, P, Q: jfn(JC, JE, k, t, P, Q))(
        jk, jt, jP, jQ))
    tout = jfn(TC, TE, tk, tt, tP, tQ)
    want = [want_fn(*a) for a in zip(ks, ts, Ps, Qs)]
    assert [TE.decode_host_point(TC, p) for p in tout] == want
    assert [JE.decode_host_point(JC, p) for p in jout] == want
    if same_formulas:
        np.testing.assert_array_equal(tout.numpy(), jout.astype(np.int64))
