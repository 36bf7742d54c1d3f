"""Three bidders on a mesh of two gloo ranks: the fused SEAL driver pads
the bidder axis with a zero bid to four lanes (tests/test_parallel.py's
padded auction), verifies, finds 3 and publishes the board of the
unsharded auction of [1, 2, 3, 0] from the same seed."""

import torch_mesh_cases as MC

JOB = {"protocol": "seal", "bids": [1, 2, 3], "c": 2, "seed": 0,
       "verify": True}


def test_seal_mesh_pads_to_the_mesh_size():
    ranks = MC.Ranks(2, [JOB], "gloo", "cpu")
    want = MC.unsharded(dict(JOB, bids=[1, 2, 3, 0]))
    for r in ranks.results():
        got = r["runs"][0]
        assert got["verified"] and got["max_bid"] == 3
        assert got["deciding"] == want["deciding"]
        assert MC.same_board(got["board"], want["board"])
        assert got["board"][0].shape[0] == 4
