"""The port's copy of the trackers (privacy_auction_tpu_torch/utils/
trackers.py) behaves as tests/test_trackers.py holds the JAX package's
to, and its communication models count the JAX package's bytes in every
category at (n, c) = (2, 1), (4, 8), (20, 32) and (64, 32), SEAL with
its steps before and after the junction.  Importing the JAX package's
trackers compiles nothing."""

import time

import torch

from privacy_auction_tpu.utils import trackers as JT
from privacy_auction_tpu_torch.utils import trackers as T

SHAPES = ((2, 1), (4, 8), (20, 32), (64, 32))
CATEGORIES = (T.CATEGORY_BIDDER, T.CATEGORY_VERIFIER, T.CATEGORY_EVALUATOR,
              T.CATEGORY_BIDDER_AND_EVALUATOR)


def _check_time_and_data_trackers():
    t = T.TimeTracker()
    t.start("bidder")
    time.sleep(0.01)
    t.stop("bidder")
    assert t.get_category_time_seconds("bidder") >= 0.01
    assert t.get_category_time_seconds("verifier") == 0.0
    with t.track("verifier", torch.zeros(2)):
        time.sleep(0.005)
    assert t.get_category_time_seconds("verifier") >= 0.005
    t.add_time("bidder", -0.01)
    assert t.get_category_time_seconds("bidder") < 0.01
    t.reset()
    assert t.get_category_time_seconds("bidder") == 0.0
    d = T.DataTracker()
    d.add_data("bidder", 500_000)
    d.add_data("verifier", 1_500_000)
    assert d.get_category_data_mb("bidder") == 0.5
    assert d.get_total_data_mb() == 2.0
    d.reset()
    assert d.get_total_data_mb() == 0.0
    assert T.TimeTracker.get_instance() is T.TimeTracker.get_instance()
    assert T.DataTracker.get_instance() is T.DataTracker.get_instance()


def _seal_bytes(mod, n, c, stage2_from):
    """Commit, then c steps, Stage2 from step `stage2_from` on."""
    d = mod.DataTracker()
    comm = mod.SealCommTracker(d)
    comm.account_commit(n, c)
    for s in range(c):
        comm.account_step(n, stage2=s >= stage2_from)
    return [d.get_category_data_mb(k) for k in CATEGORIES]


def _ccs22_bytes(mod, n, c):
    d = mod.DataTracker()
    comm = mod.Ccs22CommTracker(d)
    comm.account_setup(n, c)
    for _ in range(c):
        comm.account_step(n)
    return [d.get_category_data_mb(k) for k in CATEGORIES]


def test_trackers_match_jax():
    _check_time_and_data_trackers()
    for n, c in SHAPES:
        # the junction at step 0, at step 1, and at no step
        for stage2_from in (0, 1, c):
            assert (_seal_bytes(T, n, c, stage2_from)
                    == _seal_bytes(JT, n, c, stage2_from)), (n, c, stage2_from)
        assert _ccs22_bytes(T, n, c) == _ccs22_bytes(JT, n, c), (n, c)
    # SEAL 20x32, the C++ reference's measured size: from no junction to
    # the junction at step 0 (Stage2 from step 1 on), 26.0-34.9 MB
    low, high = (sum(_seal_bytes(T, 20, 32, s)) for s in (32, 1))
    assert 25.95 < low < 26.05 and 34.85 < high < 34.95
