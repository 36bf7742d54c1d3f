"""The port's whole-step compositions against the JAX package's
(tests/data/torch_golden_seal_step.npz, written by tools/torch_golden.py):
`full_step` at step 0 (Stage1) and step 1 (Stage2, against the deciding
step 0 of the scan body's record), `step_stage1` (a one-bit commitment,
round one, Stage1 and every check) and `step_stage2` against
`step_stage1`'s outputs, each fed the nonces the JAX function drew from
its key; and `ec.serialize_affine` with and without an infinity flag.
Every limb, flag and byte must be the JAX package's."""

import torch

from privacy_auction_tpu_torch.curves import SECP256K1 as C
from privacy_auction_tpu_torch.ops import ec
from privacy_auction_tpu_torch.protocols import seal
from torch_step_cases import IDS, assert_same, bits, draws, g, tree

torch.set_num_threads(1)


def test_full_step_step_stages_and_serialize_affine_match_jax():
    commit_pub = tree(seal.CommitmentPub, "commit_pub")
    commit_sec = tree(seal.CommitmentSec, "commit_sec")
    for s, step in ((0, 0), (1, torch.tensor(1))):     # an int and a tensor
        race, junction, prev, deciding, ok = seal.full_step_from(
            C, draws(f"full{s}"), step, bits()[:, s], g(f"step{s}.in_race"),
            g(f"step{s}.junction"), tree(seal.StepInfo, f"step{s}.prev"),
            commit_pub, commit_sec, IDS)
        assert_same(race, f"full{s}.new_race")
        assert_same(junction, f"full{s}.new_junction")
        assert_same(prev, f"full{s}.new_prev")
        assert_same(deciding, f"full{s}.deciding")
        assert_same(ok, f"full{s}.ok")
        assert bool(ok) and bool(deciding)

    deciding, ok, race, info, cpub, csec = seal.step_stage1_from(
        C, seal.CommitDraws(*(g(f"stage1.commit_draw.{k}")
                              for k in ("ab", "v", "r"))),
        draws("stage1"), g("stage1.bits"), torch.ones(len(IDS), dtype=torch.int64),
        IDS)
    for name, got in (("deciding", deciding), ("ok", ok), ("new_race", race),
                      ("info", info), ("commit_pub", cpub),
                      ("commit_sec", csec)):
        assert_same(got, f"stage1.{name}")
    assert bool(ok)
    deciding, ok = seal.step_stage2_from(C, draws("stage2"), g("stage2.bits"),
                                         race, IDS, info, cpub, csec)
    assert_same(deciding, "stage2.deciding")
    assert_same(ok, "stage2.ok")
    assert bool(ok)

    x, y, inf = g("affine.x"), g("affine.y"), g("affine.inf")
    assert_same(ec.serialize_affine(x, y), "affine.bytes")
    assert_same(ec.serialize_affine(x, y, inf), "affine.bytes_inf")
