"""The port keeps its own copies of four modules of the JAX package
(`utils/log.py`, `utils/host_curve.py`, the communication models of
`utils/trackers.py` and the native runtime binding `runtime/native.py`),
so that it imports nothing of that package.  Each copy is held to its
original by behaviour: the same log lines, the same results on seeded
points of both curves, the same message sizes and bytes, the same phase
ids, library and board traffic."""

import random

import pytest

from privacy_auction_tpu.runtime import native as JN
from privacy_auction_tpu.utils import host_curve as JH
from privacy_auction_tpu.utils import log as JL
from privacy_auction_tpu.utils import trackers as JT
from privacy_auction_tpu_torch.runtime import native as N
from privacy_auction_tpu_torch.utils import host_curve as H
from privacy_auction_tpu_torch.utils import log as L
from privacy_auction_tpu_torch.utils import trackers as T


def _check_log(capsys, monkeypatch):
    for level in ("debug", "info", "error"):
        monkeypatch.setenv("PA_TPU_LOG_LEVEL", level)
        outs = []
        for mod in (JL, L):
            # one line, so both report the same caller location
            mod.debug("d"); mod.info("i"); mod.message("m"); mod.error("e")  # noqa: E702
            outs.append(capsys.readouterr())
        assert outs[0] == outs[1], level
        assert "[ERROR]" in outs[0].err
        assert ("[MESSAGE]" in outs[0].out) == (level != "error")
        assert ("[DEBUG]" in outs[0].out) == (level == "debug")


def _check_host_curve():
    assert set(H.HOST_CURVES) == set(JH.HOST_CURVES)
    rng = random.Random(7)
    for name, hc in H.HOST_CURVES.items():
        jc = JH.HOST_CURVES[name]
        assert (hc.p, hc.a, hc.b, hc.n, hc.g) == (jc.p, jc.a, jc.b, jc.n, jc.g)
        ks = [0, 1, hc.n - 1] + [rng.randrange(hc.n) for _ in range(5)]
        pts = [None, hc.g] + [hc.mul(k, hc.g) for k in ks[3:]]
        for k in ks:
            for P in pts:
                assert hc.mul(k, P) == jc.mul(k, P)
                assert hc.add(P, pts[-1]) == jc.add(P, pts[-1])
                assert hc.neg(P) == jc.neg(P)
                assert hc.is_on_curve(P) == jc.is_on_curve(P)
            assert hc.finv(k or 1) == jc.finv(k or 1)
            v = k % hc.p
            assert hc.sqrt_mod_p(v) == jc.sqrt_mod_p(v)
        for label in (b"ccs22-crs-g1", b"ccs22-crs-h", b"x"):
            assert hc.hash_to_curve(label) == jc.hash_to_curve(label)


def _check_trackers():
    for k in ("POINT_BYTES", "SCALAR_BYTES", "CCS22_CRS_BYTES",
              "SEAL_COMMIT_PER_BIT", "SEAL_ROUND1", "SEAL_ROUND2_S1",
              "SEAL_ROUND2_S2", "CATEGORY_BIDDER", "CATEGORY_VERIFIER",
              "CATEGORY_EVALUATOR", "CATEGORY_BIDDER_AND_EVALUATOR"):
        assert getattr(T, k) == getattr(JT, k), k
    rng = random.Random(3)
    schedule = [(rng.randrange(1, 70), rng.random() < 0.5) for _ in range(20)]
    got = []
    for mod in (T, JT):
        d = mod.DataTracker()
        seal, ccs = mod.SealCommTracker(d), mod.Ccs22CommTracker(d)
        for n, flag in schedule:
            seal.account_commit(n, n % 7 + 1)
            seal.account_step(n, stage2=flag)
            ccs.account_setup(n, n % 5 + 1)
            ccs.account_step(n)
        got.append(dict(d._acc))
    assert got[0] == got[1]


def _check_native():
    for k in ("PHASE_COMMIT", "PHASE_ROUND1", "PHASE_ROUND2", "PHASE_ROUND3",
              "PHASE_OT_R1", "PHASE_OT_S", "PHASE_ANNOUNCE"):
        assert getattr(N, k) == getattr(JN, k), k
    assert N._LIB_PATH == JN._LIB_PATH            # one library for both
    assert N.available() == JN.available()
    if not N.available():
        return
    got = []
    for mod in (N, JN):
        b = mod.NativeBoard(3)
        b.post(mod.PHASE_ROUND2, 1, 2, b"m" * 77, "bidder")
        fetched = [b.fetch(mod.PHASE_ROUND2, 1, j, "verifier") for j in range(3)]
        b.account("evaluator", 5)
        got.append((fetched, b.bytes("bidder"), b.bytes("verifier"),
                    b.bytes("evaluator"), b.total_bytes(), b.n_parties))
    assert got[0] == got[1]


def test_copies_behave_as_their_originals(capsys, monkeypatch):
    _check_log(capsys, monkeypatch)
    _check_host_curve()
    _check_trackers()
    _check_native()
