"""The CCS22 auction on a bidder mesh of two gloo ranks on the CPU, the
evaluator at lane 2 (on rank 0 of the two): the fused driver equals the
unsharded port run from the same seed, its board bit for bit, and the
role-metered driver on the mesh announces the same bits
(tests/test_parallel.py's check of the JAX package's mesh)."""

import torch_mesh_cases as MC

JOB = {"protocol": "ccs22", "bids": [4, 9, 1, 11, 0, 3, 8, 2], "c": 4,
       "seed": 7, "eval_id": 2}
METERED = dict(JOB, metered=True)


def test_ccs22_auction_on_two_ranks_equals_unsharded():
    ranks = MC.Ranks(2, [JOB, METERED], "gloo", "cpu")
    want = MC.unsharded(JOB)
    assert want["max_bid"] == 11
    for r in ranks.results():
        fused, metered = r["runs"]
        assert fused["max_bid"] == metered["max_bid"] == 11
        assert fused["deciding"] == metered["deciding"] == want["deciding"]
        assert MC.same_board(fused["board"], want["board"])
