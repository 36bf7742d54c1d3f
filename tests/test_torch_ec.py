"""The PyTorch port's curve constants, GLV split and point layer against the
JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from privacy_auction_tpu.curves import SECP256K1 as JC
from privacy_auction_tpu.ops import ec as JE
from privacy_auction_tpu.ops import pallas_ec as JPE
from privacy_auction_tpu_torch.curves import SECP256K1 as TC
from privacy_auction_tpu_torch.ops import ec as TE
from privacy_auction_tpu_torch.ops import field as TF
from torch_ec_cases import HOST, edge_inputs

torch.set_num_threads(1)


def _check_curve_constants_match_jax():
    np.testing.assert_array_equal(TC.comb_table, JC.comb_table)
    np.testing.assert_array_equal(TC.generator_affine, JC.generator_affine)
    for f in ("lam", "beta", "n", "a1", "b1", "a2", "b2", "g1", "g2"):
        assert getattr(TC.glv, f) == getattr(JC.glv, f), f
    for f in ("beta_limbs", "a1n_limbs", "a2n_limbs", "b1n_limbs", "b2n_limbs",
              "g1_limbs", "g2_limbs"):
        np.testing.assert_array_equal(getattr(TC.glv, f), getattr(JC.glv, f))
    assert (TC.fp.modulus, TC.fn.modulus, TC.b3) == (JC.fp.modulus,
                                                     JC.fn.modulus, JC.b3)
    # window-0 tables of G and phi(G): the TPU kernel's (48, 16) f32 form
    for mine, theirs in zip(TC.g0_tables, (JPE._g0_table_np(JC),
                                           JPE._g0l_table_np(JC))):
        np.testing.assert_array_equal(mine, theirs.T.reshape(16, 3, 16))


def _check_glv_decompose_matches_jax():
    n, lam = HOST.n, TC.glv.lam
    ks = [0, 1, 2, n - 1, n // 2, n // 2 + 1, lam, lam * lam % n] + [
        (0x9E3779B97F4A7C15 * (i + 1)) ** 3 % n for i in range(4)]
    limbs = TF.ints_to_limbs(ks)
    jout = jax.jit(lambda k: JE.glv_decompose(JC, k))(jnp.asarray(limbs))
    tout = TE.glv_decompose(TC, torch.as_tensor(limbs))
    for j, t in zip(jout, tout):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j).astype(t.numpy().dtype))
    k1, s1, k2, s2 = tout
    for i, k in enumerate(ks):
        m1 = TF.limbs_to_int(k1[i]) * (-1 if bool(s1[i]) else 1)
        m2 = TF.limbs_to_int(k2[i]) * (-1 if bool(s2[i]) else 1)
        assert (m1 + m2 * lam - k) % n == 0
        assert max(abs(m1), abs(m2)) < (1 << 132)


def _check_point_ops_match_jax():
    """add, dbl, neg, eq, endo_apply, the fixed-order prefix scan and the
    SEC1 serialization: projective limbs bit-identical to JAX."""
    _, _, P, Q = edge_inputs()
    jP, jQ = (jnp.asarray(JE.encode_host_points(x)) for x in (P, Q))
    tP, tQ = (torch.as_tensor(np.asarray(x).astype(np.int64)) for x in (jP, jQ))

    def ops(C, E, P, Q):
        return (E.add(C, P, Q), E.dbl(C, P), E.neg(C, P), E.eq(C, P, P),
                E.endo_apply(C, P), E.ec_sum(C, P), E.serialize_uncompressed(C, Q))

    jout = jax.jit(lambda P, Q: ops(JC, JE, P, Q))(jP, jQ)
    tout = ops(TC, TE, tP, tQ)
    for j, t in zip(jout, tout):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j).astype(t.numpy().dtype))
    want = [HOST.add(a, b) for a, b in zip(P, Q)]
    assert [TE.decode_host_point(TC, p) for p in tout[0]] == want
    scan = TE.ec_prefix_scan(TC, tP)
    acc = None
    for i, p in enumerate(P):
        acc = HOST.add(acc, p)
        assert TE.decode_host_point(TC, scan[i]) == acc


# One test per file: pytest-xdist (--dist loadfile) queues files by test
# count, and one-test files go last, after the long-running files of the
# tier-1 run have been handed out (see ROADMAP.md, Queue 3).
def test_curve_glv_and_point_layer_match_jax():
    """Constants, the GLV split and the point layer."""
    _check_curve_constants_match_jax()
    _check_glv_decompose_matches_jax()
    _check_point_ops_match_jax()
