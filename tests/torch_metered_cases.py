"""Loader of the metered-driver golden vectors that tools/torch_golden.py
wrote from the JAX package (tests/data/torch_golden_metered.npz), and the
port's side of each case: the tamper hooks of tests/test_adversarial.py
written for the port's tensors, and a recorder of the checks the port's
metered SEAL loop runs.  Each case has a test file of its own, so that
each file stays short."""

import pathlib

import numpy as np
import torch

from privacy_auction_tpu_torch.curves import SECP256K1 as C
from privacy_auction_tpu_torch.ops import ec
from privacy_auction_tpu_torch.protocols import seal
from privacy_auction_tpu_torch.utils import trackers as T

GOLD = np.load(pathlib.Path(__file__).resolve().parent / "data"
               / "torch_golden_metered.npz")
CHECKS = [str(s) for s in GOLD["checks"]]
HOOK_PHASES = [str(s) for s in GOLD["hook_phases"]]
TAMPER_CASES = [str(s) for s in GOLD["tamper_cases"]]
SEAL_BIDS = [int(b) for b in GOLD["seal.bids"]]
SEAL_C = int(GOLD["seal.c"])
SEED = 42


def record_checks(monkeypatch) -> list:
    """Wraps the port's four SEAL checks; each call appends (check index in
    CHECKS, step or -1, passed) to the returned list, as the golden tool
    records the JAX loop's.  The step's position in each check's
    arguments is the same in both packages."""
    calls = []

    def recorded(name, fn, step_arg):
        def run(*args):
            ok = fn(*args)
            step = -1 if step_arg is None else int(args[step_arg])
            calls.append((CHECKS.index(name), step, int(bool(ok.all()))))
            return ok
        return run

    for attr, name, step_arg in (
            ("verify_commit", "verify_commit", None),
            ("verify_round_one", "verify_round_one", 3),
            ("verify_round_two_stage1", "verify_round_two", 6),
            ("verify_round_two_stage2", "verify_round_two", 7)):
        monkeypatch.setattr(seal, attr, recorded(name, getattr(seal, attr),
                                                 step_arg))
    return calls


def _bump(P, *idx):
    """A copy of P with P[idx] replaced by P[idx] + G: well formed, and
    inconsistent with every proof that binds it."""
    P = P.clone()
    P[idx] = ec.add(C, P[idx], ec.generator(C, P.device))
    return P


def tamper(case):
    """The hook of tests/test_adversarial.py's case `case`."""
    def hook(phase, step, pub):
        if case == "phi" and phase == "commit":
            return pub._replace(phi=_bump(pub.phi, 0, 0))
        if case == "round1_x" and phase == "round1" and step == 0:
            return pub._replace(X=_bump(pub.X, 1))
        if case == "stage1_b" and phase == "round2" and step == 0:
            assert pub.proof1 is not None, "step 0 is before the junction"
            return pub._replace(b=_bump(pub.b, 0))
        if case == "stage2_b" and phase == "round2" and step == 1:
            assert pub.proof2 is not None, "step 1 must be post-junction"
            return pub._replace(b=_bump(pub.b, 2))
        if case == "stage2_ch2" and phase == "round2" and step == 1:
            ch2 = pub.proof2.ch2.clone()
            ch2[..., 0] ^= 1
            return pub._replace(proof2=pub.proof2._replace(ch2=ch2))
        return pub
    return hook


def run_seal(device="cpu", **kw):
    return seal.run_auction(C, SEAL_BIDS, SEAL_C, verify=True,
                            generator=torch.Generator().manual_seed(SEED),
                            device=device, **kw)


def check_tamper(case, monkeypatch, device="cpu"):
    """The auction with case `case`'s hook aborts as the JAX package's
    did: verified=False, max_bid=-1, at the same check of the same step.
    Returns the checks run."""
    checks = record_checks(monkeypatch)
    res = run_seal(device, tamper=tamper(case))
    assert not res.verified and res.max_bid == -1
    assert res.max_bid == int(GOLD[f"tamper.{case}.max_bid"])
    assert res.verified == bool(GOLD[f"tamper.{case}.verified"])
    assert checks[-1] == tuple(int(v) for v in GOLD[f"tamper.{case}.abort"])
    assert checks[-1][2] == 0 and all(ok for _, _, ok in checks[:-1])
    return checks


def check_honest(monkeypatch, device="cpu"):
    """The metered loop with an identity hook verifies, finds the maximum,
    and matches the JAX loop in deciding bits, bytes per category, the
    hook's calls and the checks it runs; both roles accrue time."""
    checks = record_checks(monkeypatch)
    hook_calls = []

    def identity(phase, step, pub):
        hook_calls.append((HOOK_PHASES.index(phase),
                           -1 if step is None else step,
                           int(getattr(pub, "proof1", None) is None),
                           int(getattr(pub, "proof2", None) is None)))
        return pub

    data, times = T.DataTracker(), T.TimeTracker()
    res = run_seal(device, times=times, trackers=T.SealCommTracker(data),
                   tamper=identity)
    assert res.verified and res.max_bid == max(SEAL_BIDS)
    assert res.max_bid == int(GOLD["seal.max_bid"])
    assert res.verified == bool(GOLD["seal.verified"])
    np.testing.assert_array_equal(res.deciding_bits, GOLD["seal.deciding_bits"])
    assert category_bytes(data, "seal") == GOLD["seal.bytes"].tolist()
    assert hook_calls == [tuple(r) for r in GOLD["seal.hook_calls"].tolist()]
    assert checks == [tuple(r) for r in GOLD["seal.checks"].tolist()]
    assert times.get_category_time_seconds(T.CATEGORY_BIDDER) > 0
    assert times.get_category_time_seconds(T.CATEGORY_VERIFIER) > 0


def category_bytes(data: T.DataTracker, prefix: str):
    return [int(round(data.get_category_data_mb(str(k)) * 1e6))
            for k in GOLD[f"{prefix}.categories"]]
