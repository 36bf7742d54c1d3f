"""The port's CLI prints the per-role report of the JAX package's CLI on
the CPU: time and data per bidder and per verifier (per evaluator for
CCS22, with the CRS split per party) and the total data, with the data
figures those of the communication models (held to the JAX package's in
tests/test_torch_trackers.py), and exits 0 on a verified auction that
finds the maximum.  2 bidders x 1 bit, --cold (no warm-up auction)."""

import re

import torch

from privacy_auction_tpu_torch import cli
from privacy_auction_tpu_torch.utils import trackers as T

torch.set_num_threads(1)


def _report(capsys, argv):
    assert cli.main(argv + ["--seed", "3", "--device", "cpu", "--cold"]) == 0
    out = capsys.readouterr().out
    assert "OK: maxBid" in out
    return {f"{kind} ({who})": float(v) for kind, who, v in
            re.findall(r"\] (Time|Data) \(([^)]*)\): ([0-9.]+)", out)}


def test_cli_per_role_report(capsys):
    n, c = 2, 1
    seal = _report(capsys, ["seal", str(n), str(c)])
    d = T.DataTracker()
    comm = T.SealCommTracker(d)
    comm.account_commit(n, c)
    comm.account_step(n, stage2=False)
    assert seal["Time (one bidder)"] > 0 and seal["Time (one verifier)"] > 0
    assert seal["Data (one bidder)"] == round(
        d.get_category_data_mb(T.CATEGORY_BIDDER) / n, 6)
    assert seal["Data (one verifier)"] == round(
        d.get_category_data_mb(T.CATEGORY_VERIFIER) / n, 6)
    assert seal[f"Data (total communication, #bidders={n}, #verifiers={n})"] \
        == round(d.get_total_data_mb(), 6)

    ccs = _report(capsys, ["ccs22", str(n), str(c)])
    d = T.DataTracker()
    comm = T.Ccs22CommTracker(d)
    comm.account_setup(n, c)
    comm.account_step(n)
    shared = d.get_category_data_mb(T.CATEGORY_BIDDER_AND_EVALUATOR) / n
    assert ccs["Time (one bidder)"] > 0 and ccs["Time (one evaluator)"] > 0
    assert ccs["Data (one bidder)"] == round(
        d.get_category_data_mb(T.CATEGORY_BIDDER) / (n - 1) + shared, 6)
    assert ccs["Data (one evaluator)"] == round(
        d.get_category_data_mb(T.CATEGORY_EVALUATOR) + shared, 6)
    assert ccs[f"Data (total communication, #bidders={n - 1}, #evaluators=1)"] \
        == round(d.get_total_data_mb(), 6)
