"""The metric readers on records made by hand: each reads its number, or
nothing where the run has nothing to read."""

import pytest

from auction_bench import run as R
from auction_bench import yardstick as Y


def graph(kernels=100, replays=4, replay_s=0.2):
    return {"warmup_s": 0.5, "capture_s": 0.25, "instantiate_s": 0.125,
            "kernels": kernels, "replays": replays, "replay_s": replay_s,
            "launches": {}}


def records(profile=None):
    auctions = [
        {"wall_s": 2.0, "phase_s": {"commit": 0.5, "steps": 1.0, "b01": 0.25},
         "graphs": [graph(), graph(200, 6, 0.6)], "profiled": False},
        {"wall_s": 9.0, "phase_s": {"commit": 5.0, "steps": 3.0},
         "graphs": [graph(), graph(200, 6, 6.0)], "profiled": True},
        {"wall_s": 2.0, "phase_s": {"commit": 0.25, "steps": 1.0},
         "graphs": [graph(), graph(200, 6, 0.6)], "profiled": False},
    ]
    return {"setup_s": 12.5, "window_s": 13.0, "auctions": auctions,
            "peak_bytes": 3 * 2**30, "sms": 132, "profile": profile}


def profile():
    return {"window_s": 10.0, "busy_s": 2.5, "auctions": 2,
            "ec_kernel_s": 0.5, "ec_kernel_count": 12,
            "sha256_kernel_s": 0.07, "sha256_kernel_count": 4,
            "launches": {("quad_mul", 2048): 10, ("mul_comb", 4096): 2,
                         ("sha256", 20): 4}}


def read(name, recs):
    return R.load_metric(name)(recs)


def test_end_to_end():
    r = records()
    assert read("setup_s", r) == 12.5
    assert read("auction_s", r) == pytest.approx(13.0 / 3)


def test_counters_skip_the_profiled_auctions():
    r = records()
    assert read("eager_phases_s", r) == pytest.approx((0.75 + 0.25) / 2)
    assert read("graph_setup_s", r) == pytest.approx(2 * 0.875)
    assert read("replay_ms", r) == pytest.approx(1e3 * 1.6 / 20)
    assert read("graph_kernel_nodes", r) == 300
    assert read("peak_mem_gib", r) == 3


def test_device_metrics():
    r = records(profile())
    assert read("device_idle_pct", r) == pytest.approx(75.0)
    assert read("sha256.device_ms", r) == pytest.approx(35.0)
    bound = (10 * Y.launch_bound_s("quad_mul", 2048, 132)
             + 2 * Y.launch_bound_s("mul_comb", 4096, 132))
    assert read("ec_kernels_roofline", r) == pytest.approx(100 * bound / 0.5)


@pytest.mark.parametrize("name", ["ec_kernels_roofline", "sha256.device_ms",
                                  "device_idle_pct"])
def test_nothing_to_read_gives_nothing(name):
    assert read(name, records()) is None


def test_untraced_auctions_have_no_phases():
    r = records()
    for a in r["auctions"]:
        a["phase_s"] = None
        a["graphs"] = []
    for name in ("eager_phases_s", "graph_setup_s", "replay_ms",
                 "graph_kernel_nodes"):
        assert read(name, r) is None
