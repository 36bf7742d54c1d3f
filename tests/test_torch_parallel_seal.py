"""The fused SEAL auction on a bidder mesh of two gloo ranks on the CPU
(`seal.run_auction(mesh=...)`) equals the unsharded port run from the same
seed: verified, the maximum, the deciding bits and every tensor of the
published board, bit for bit, on both ranks (tests/test_parallel.py's
check of the JAX package's mesh)."""

import torch_mesh_cases as MC

JOB = {"protocol": "seal", "bids": [5, 3, 7, 2, 7, 0, 1, 6], "c": 3,
       "seed": 42, "verify": True}


def test_seal_auction_on_two_ranks_equals_unsharded():
    ranks = MC.Ranks(2, [JOB], "gloo", "cpu")
    want = MC.unsharded(JOB)
    assert want["verified"] and want["max_bid"] == 7
    results = ranks.results()
    assert [r["info"]["process_index"] for r in results] == [0, 1]
    for r in results:
        got = r["runs"][0]
        assert r["backend"] == "gloo" and r["info"]["global_devices"] == 2
        assert got["verified"] and got["max_bid"] == want["max_bid"] == 7
        assert got["deciding"] == want["deciding"]
        assert MC.same_board(got["board"], want["board"])
