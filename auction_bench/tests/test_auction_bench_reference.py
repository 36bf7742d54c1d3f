"""The plain reference against the port's plain path on the CPU: it passes
the boards of small auctions whole, every lane, and finds a changed
entry."""

import random

import pytest

from auction_bench import traffic as T
from auction_bench.reference import ccs22 as RC
from auction_bench.reference import secp256k1 as E

from ._cpu import small_cell

_CACHE = {}


def auction(workload):
    """One auction of the cell at its small size, its host copy with every
    lane kept, and those lanes."""
    if workload not in _CACHE:
        cell = small_cell(workload)
        state = cell.driver.prepare(cell.config, cell.mix, "cpu")
        a = T.auction(cell.mix, 2**32 + 17, 0)
        lanes = [(i, j) for i in range(cell.mix.n) for j in range(cell.mix.c)]
        result = cell.driver.run(state, a)
        host = cell.driver.to_host(cell.driver.keep(result, a, lanes))
        _CACHE[workload] = (cell, a, lanes, host)
    return _CACHE[workload]


def judge(workload, host=None):
    cell, a, lanes, kept = auction(workload)
    return cell.driver.check(kept if host is None else host, a, lanes,
                             E.Bases(), cell.mix)


@pytest.mark.parametrize("workload", ["seal-20x32", "ccs22-1024x64"])
def test_board_of_the_port_passes(workload):
    assert judge(workload) == {"outcome": [], "board": []}


def _copy(host):
    import copy

    return copy.deepcopy(host)


@pytest.mark.parametrize("part,field", [("stage1", "rho11"),
                                        ("stage2", "rho23"),
                                        ("stage2", "eps31p"),
                                        ("lanes", "powf_ch2"),
                                        ("lanes", "pok_r_eps")])
def test_seal_finds_a_changed_proof_entry(part, field):
    host = _copy(auction("seal-20x32")[3])
    host[part][field][0, 0] ^= 1
    bad = judge("seal-20x32", host)
    assert bad["board"] and not bad["outcome"]


def test_seal_finds_a_changed_ciphertext_and_outcome():
    host = _copy(auction("seal-20x32")[3])
    host["b"][0, 0, 0, 0] ^= 1
    host["max_bid"] += 1
    bad = judge("seal-20x32", host)
    assert bad["board"] and bad["outcome"]


@pytest.mark.parametrize("field", ["T2", "G", "H", "z", "C0", "C1"])
def test_ccs22_finds_a_changed_ot_message(field):
    host = _copy(auction("ccs22-1024x64")[3])
    host["lanes"][field][3, 0, 0] ^= 1
    assert judge("ccs22-1024x64", host)["board"] == [
        f"lane {auction('ccs22-1024x64')[2][3]} {field}"]


def test_ccs22_finds_a_changed_commitment_and_key():
    host = _copy(auction("ccs22-1024x64")[3])
    host["com"][0, 1, 0] ^= 1
    host["X_steps"][1, 0, 0, 0] ^= 1
    assert len(judge("ccs22-1024x64", host)["board"]) >= 2


def test_ccs22_draws_are_the_documented_words():
    w = RC.draw_words(5, 3, 2)
    assert w["x"].shape == (3, 2, 8) and w["rcom"].shape == (3, 8)
    assert RC.scalar([1, 2, 0, 0, 0, 0, 0, 0]) == 1 + (2 << 32)


def test_curve_arithmetic():
    rng = random.Random(3)
    bases = E.Bases()
    Q = bases.comb(E.G).mul(12345)
    assert E.on_curve(Q) and E.on_curve(RC.G1) and E.on_curve(RC.H)
    for _ in range(5):
        k, t = rng.randrange(E.N), rng.randrange(E.N)
        k1, k2 = E.glv_split(k)
        assert (k1 + k2 * E.LAMBDA - k) % E.N == 0
        assert max(abs(k1), abs(k2)) < 2**129
        assert E.mul(k, Q) == bases.comb(Q).mul(k)
        assert bases.lin([(k, E.G)], [(t, Q)]) == E.add(E.mul(k, E.G),
                                                          E.mul(t, Q))
    assert E.mul(E.N - 1, Q) == E.neg(Q)
    assert E.mul(E.LAMBDA, Q) == (Q[0] * E.BETA % E.P, Q[1])
