"""The EC operations that cross bidders, on a bidder mesh of two gloo ranks
on the CPU (the port's `parallel/`): the point sum and the AV-net keys over
the gathered rows and the lane-local scalar mult (the plain path) equal
the unsharded ones limb for limb, as tests/test_parallel.py holds the JAX
package's sharded ops to its unsharded ones."""

import torch

import torch_mesh_cases as MC

JOB = {"protocol": "ec", "n": 16, "seed": 16}


def test_sharded_ec_sum_scalar_mul_and_avnet_keys_equal_unsharded():
    ranks = MC.Ranks(2, [JOB], "gloo", "cpu")
    want = MC.unsharded(JOB)
    for r in ranks.results():
        got = r["runs"][0]
        for name in ("sum", "mul", "avnet"):
            assert torch.equal(got[name], want[name]), (r["rank"], name)
    assert want["mul"].shape == (16, 3, 16) and want["sum"].shape == (3, 16)
