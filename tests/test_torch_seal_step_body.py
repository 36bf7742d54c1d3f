"""The port's fused SEAL step (`seal.step_body`) against the JAX package's
scan body, and the fused driver built on it against the metered driver.

tools/torch_golden.py ran the JAX scan (`seal._scan_steps`) at bids
[5, 3, 6], c = 3, one jitted body call a step, and recorded what each step
took (the carried race, junction and last deciding step; the stage proof's
nonces from the step's key) and gave (the new carry, the deciding bit, the
proof check), with the proof the body generated
(tests/data/torch_golden_seal_step.npz).  Step 0 runs Stage1 and decides;
steps 1 and 2 run Stage2 against step 0's state, carried.  Fed the same
inputs and nonces, the step index a tensor, the port's body gives the
same limbs and flags.  Then the fused driver, whose steps are this body,
and the role-metered driver publish the same board from one seed, Stage2
steps included (verification off: it draws and publishes nothing)."""

import torch

from privacy_auction_tpu_torch import nizk
from privacy_auction_tpu_torch.curves import SECP256K1 as C
from privacy_auction_tpu_torch.protocols import seal
from privacy_auction_tpu_torch.utils import trackers as T
from test_torch_seal_metered import _assert_same
from torch_step_cases import (BIDS, C_BITS, GOLD, IDS, assert_same, bits, g,
                              tree)

torch.set_num_threads(1)


def _precomputed():
    """The streams `_precompute` gave the JAX scan; the body reads X, R, x,
    Y, b0 and b1 (the round-one proofs and r are checked before the
    steps: zeros here)."""
    X, x = g("pre.X"), g("pre.x")
    pok = nizk.PoKDLog(torch.zeros_like(X), torch.zeros_like(x))
    return seal.Precomputed(
        pub1=seal.RoundOnePub(X=X, R=g("pre.R"), pok_x=pok, pok_r=pok),
        sec1=seal.RoundOneSec(x=x, r=torch.zeros_like(x)), Y=g("pre.Y"),
        b0=g("pre.b0"), b1=g("pre.b1"))


def test_step_body_matches_jax_and_fused_board_matches_metered():
    pre = _precomputed()
    commit_pub = tree(seal.CommitmentPub, "commit_pub")
    commit_sec = tree(seal.CommitmentSec, "commit_sec")
    stages = []
    for s in range(C_BITS):
        stage2 = bool(GOLD[f"step{s}.junction"])
        stages.append(stage2)
        pub2, race, prev, deciding, ok = seal.step_body(
            C, g(f"step{s}.r"), torch.tensor(s), bits(), IDS, pre, commit_pub,
            commit_sec, g(f"step{s}.in_race"),
            tree(seal.StepInfo, f"step{s}.prev"), stage2, verify=True)
        assert_same(pub2.b, f"step{s}.b")
        assert_same(pub2.proof2 if stage2 else pub2.proof1, f"step{s}.proof")
        assert (pub2.proof1 is None) == stage2 != (pub2.proof2 is None)
        assert_same(race, f"step{s}.new_race")
        assert_same(prev, f"step{s}.new_prev")
        assert_same(deciding, f"step{s}.deciding")
        assert_same(ok, f"step{s}.ok")
        assert bool(ok) and (stage2 or bool(deciding)) == bool(
            GOLD[f"step{s}.new_junction"])
    assert stages == [False, True, True]
    assert GOLD["scan.deciding"].tolist() == [True, True, False]

    runs = []
    for times in (None, T.TimeTracker()):
        gen = torch.Generator().manual_seed(11)
        res = seal.run_auction(C, BIDS, C_BITS, verify=False, generator=gen,
                               device="cpu", times=times)
        runs.append((res, gen.get_state()))
    (fused, state_f), (metered, state_m) = runs
    assert fused.max_bid == metered.max_bid == max(BIDS)
    assert fused.deciding_bits.tolist() == metered.deciding_bits.tolist() \
        == [1, 1, 0]
    assert [p.proof2 is None for p in fused.board.round2] == [True, False, False]
    _assert_same(fused.board, metered.board)
    assert torch.equal(state_f, state_m)
