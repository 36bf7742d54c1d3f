"""The port's fused CCS22 step (`ccs22.step_body`) against the JAX
package's scan body.

tools/torch_golden.py ran the JAX driver's setup, `_precompute` and its
step scan (`_jit_scan_steps`) at bids [5, 3, 2, 6], c = 3, with the
evaluator at lane 0 and at the last lane, and recorded the drawn scalars,
the precomputed streams and each step's announced bit, OTR1 and OTS
(tests/data/torch_golden_ccs22_step.npz).  Both evaluators' choice bits
take both values over the steps, and the race drops lanes at steps 0 and
1.  Fed the same streams, the step index a tensor and the race carried,
the port's body gives every step's messages, limb for limb; so do its
uncaptured steps (`_scan_steps`, whose body advances the index itself),
and the fused driver fed the recorded draws with the evaluator at the last
lane (tests/test_torch_ccs22_auction*.py run it at other lanes)."""

import pathlib

import numpy as np
import torch

from privacy_auction_tpu_torch import interop
from privacy_auction_tpu_torch.curves import SECP256K1 as C
from privacy_auction_tpu_torch.protocols import ccs22, seal

torch.set_num_threads(1)

GOLD = np.load(pathlib.Path(__file__).resolve().parent / "data"
               / "torch_golden_ccs22_step.npz")
BIDS = [int(b) for b in GOLD["bids"]]
N, C_BITS = len(BIDS), int(GOLD["c"])
EVALS = [int(e) for e in GOLD["evals"]]


def g(name):
    return interop.to_torch(GOLD[name], device="cpu")


def _same(got, name, step=None):
    want = GOLD[name] if step is None else GOLD[name][step]
    np.testing.assert_array_equal(got.numpy(), want.astype(got.numpy().dtype),
                                  err_msg=f"{name} step {step}")


def _same_messages(r1, ots, prefix, step=None):
    for part, tup in (("otr1", r1), ("ots", ots)):
        for f, v in tup._asdict().items():
            _same(v, f"{prefix}.{part}.{f}", step)


def test_step_body_matches_jax_scan_at_both_evaluators():
    pre = ccs22.Precomputed(*(g(f"pre.{k}") for k in ccs22.Precomputed._fields))
    bits = torch.as_tensor(seal.bids_to_bits(BIDS, C_BITS))
    g1n = ccs22.pp_or_make(C, "cpu").g1.expand(N, 3, ccs22.LIMBS)
    sec = ccs22.SetupSec(*(g(f"draw.{k}") for k in ccs22.SetupSec._fields))
    draws = ccs22.Draws(beta=g("draw.beta"), sec=sec, k_rand=g("draw.k_rand"),
                        m1k=g("draw.m1k"))
    assert EVALS == [0, N - 1]
    for eid in EVALS:
        prefix = f"e{eid}"
        eidt = ccs22.eval_index(eid, "cpu")
        in_race = torch.ones((N,), dtype=torch.int64)
        for s in range(C_BITS):
            ann, in_race, r1, ots = ccs22.step_body(
                C, torch.tensor([s]), pre, g1n, bits, eidt, in_race)
            _same(ann, f"{prefix}.announced", s)
            _same_messages(r1, ots, prefix, s)
        # the race after the last step: only the maximum's bidder is left
        assert in_race.tolist() == [int(b == max(BIDS)) for b in BIDS]
        announced, r1, ots = ccs22._scan_steps(C, pre, g1n, bits, eidt)
        _same(announced, f"{prefix}.announced")
        _same_messages(r1, ots, prefix)
    res = ccs22.run_auction(C, BIDS, C_BITS, EVALS[-1], device="cpu",
                            draws=draws)
    assert res.max_bid == max(BIDS)
    _same(res.board.announced, f"e{EVALS[-1]}.announced")
    _same_messages(res.board.otr1, res.board.ots, f"e{EVALS[-1]}")
