"""The traffic generator: the same seed gives the same auctions, every
seed the same sizes."""

import pathlib

import pytest

from auction_bench import traffic as T

MIX = T.Mix.from_dict("t", {"n": 1024, "c": 64, "bids": "uniform",
                            "loop": "closed", "clients": 1, "check_lanes": 16,
                            "profile_auctions": 2})
SEEDS = [0, 7, 2**31 + 5, 2**33 - 1]


@pytest.mark.parametrize("seed", SEEDS)
def test_deterministic(seed):
    for i in range(3):
        a, b = T.auction(MIX, seed, i), T.auction(MIX, seed, i)
        assert a == b
        assert T.sample_lanes(MIX, a) == T.sample_lanes(MIX, b)


def test_seeds_and_streams_differ():
    firsts = {T.auction(MIX, s, 0).bids for s in SEEDS}
    assert len(firsts) == len(SEEDS)
    assert T.auction(MIX, 5, 0) != T.auction(MIX, 5, 0, T.WARMUP)
    assert T.auction(MIX, 5, 0) != T.auction(MIX, 5, 1)


@pytest.mark.parametrize("seed", SEEDS)
def test_sizes_do_not_depend_on_the_seed(seed):
    a = T.auction(MIX, seed, 0)
    assert len(a.bids) == MIX.n
    assert all(0 <= b < 2**MIX.c for b in a.bids)
    assert 0 <= a.eval_id < MIX.n
    lanes = T.sample_lanes(MIX, a)
    assert len({j for _, j in lanes}) == MIX.check_lanes
    assert all(0 <= i < MIX.n for i, _ in lanes)


def test_lanes_cover_every_step_before_any_twice():
    mix = T.Mix.from_dict("s", {"n": 20, "c": 32, "bids": "uniform",
                                "loop": "closed", "clients": 1,
                                "check_lanes": 32, "profile_auctions": 1})
    lanes = T.sample_lanes(mix, T.auction(mix, 3, 0))
    assert sorted(j for _, j in lanes) == list(range(32))


def test_bids_spread_over_their_range():
    bids = [b for s in range(20) for b in T.auction(MIX, s, 0).bids]
    assert max(bids) > 2**63 and min(bids) < 2**60


@pytest.mark.parametrize("path", sorted(
    (pathlib.Path(T.__file__).parent / "traffic").glob("*.json")))
def test_mix_files_load(path):
    import json

    mix = T.Mix.from_dict(path.stem, json.loads(path.read_text()))
    assert mix.n >= 2 and 1 <= mix.c <= 64


def test_unknown_key_is_refused():
    with pytest.raises(ValueError):
        T.Mix.from_dict("x", {"n": 2, "c": 2, "bids": "uniform",
                              "loop": "closed", "clients": 1,
                              "check_lanes": 1, "profile_auctions": 1,
                              "rate": 3})
