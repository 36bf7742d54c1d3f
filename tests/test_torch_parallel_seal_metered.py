"""The role-metered SEAL loop on a mesh of two gloo ranks (`run_auction`
with `times=` and a board hook): three bidders padded to four lanes, it
verifies, finds 3 and publishes the board of the unsharded fused auction
of [1, 2, 3, 0] from the same seed; the hook sees each whole four-lane
message, gathered from both ranks, once a phase."""

import torch_mesh_cases as MC

JOB = {"protocol": "seal", "bids": [1, 2, 3], "c": 2, "seed": 0,
       "verify": True}


def test_metered_seal_on_two_ranks_hooks_the_whole_board():
    ranks = MC.Ranks(2, [dict(JOB, metered=True)], "gloo", "cpu")
    want = MC.unsharded(dict(JOB, bids=[1, 2, 3, 0]))
    for r in ranks.results():
        got = r["runs"][0]
        assert got["verified"] and got["max_bid"] == 3
        assert got["deciding"] == want["deciding"]
        assert MC.same_board(got["board"], want["board"])
        assert [h[:2] for h in got["hook"]] == [
            ("commit", None), ("round1", 0), ("round2", 0), ("round1", 1),
            ("round2", 1)]
        assert all(h[2] == 4 for h in got["hook"])
