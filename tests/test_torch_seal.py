"""The PyTorch port's SEAL building blocks against golden JAX values.

tools/torch_golden.py ran the JAX package on seeded inputs and recorded the
board, the nonces each proof generator drew, the Fiat-Shamir challenges
and the proofs (tests/data/torch_golden_seal.npz).  Fed the same inputs
and nonces, the port must reproduce every byte: randomness seam,
commitments, round-1 keys, AV-net keys, ciphertext candidates, challenges
and all proof scalars and points.  The verifiers are in
tests/test_torch_seal_verify.py.
"""

import numpy as np
import torch

from privacy_auction_tpu_torch import nizk
from privacy_auction_tpu_torch.curves import SECP256K1 as C
from privacy_auction_tpu_torch.ops import ec
from privacy_auction_tpu_torch.ops import field as F
from privacy_auction_tpu_torch.protocols import seal
from torch_golden_cases import (GOLD, IDS, N, assert_same, bits, g,
                                stage1_inputs, stage2_inputs)

torch.set_num_threads(1)


def _eq(t, name):
    np.testing.assert_array_equal(t.numpy(), GOLD[name].astype(np.int64),
                                  err_msg=name)


def _check_commit_board_and_pokdlogs_match_jax():
    """Random words -> scalars, phi/A/B and the nonce commitments (comb
    ladder), the PoKDLog challenge and response."""
    for name in ("alpha", "beta", "commit_v", "r1_xr", "r1_v"):
        _eq(F.from_random_bits(C.fn, g(name + "_words")), name)
    alpha, beta, v = g("alpha"), g("beta"), g("commit_v")
    bit_limbs = torch.zeros_like(alpha)
    bit_limbs[..., 0] = bits()
    exp_phi = F.add(C.fn, F.mul(C.fn, alpha, beta), bit_limbs)
    pts = ec.mul_base(C, torch.stack([exp_phi, alpha, beta, v[0], v[1]]))
    for i, name in enumerate(("phi", "A", "B")):
        _eq(pts[i], name)
    ids = IDS[:, None].expand(N, 2).expand(2, N, 2)
    steps = torch.arange(2).expand(N, 2).expand(2, N, 2)
    X, x = torch.stack([pts[1], pts[2]]), torch.stack([alpha, beta])
    _eq(nizk.fs_challenge(C, [pts[3:5], X], ids, nizk.TAG_POKDLOG, steps),
        "commit_pok_ch")
    assert_same(nizk.gen_pokdlog_from(C, v, pts[3:5], X, x, ids, steps),
                "commit_pok")


def _check_powfcom_matches_jax():
    n_c = (N, 2)
    pok = nizk.gen_powfcom_from(
        C, g("powf_r"), g("phi"), g("A"), g("B"), g("alpha"), bits(),
        IDS[:, None].expand(n_c), torch.arange(2).expand(n_c))
    assert_same(pok, "powf")


def _check_round_one_avnet_and_ciphertexts_match_jax():
    xr, v = g("r1_xr"), g("r1_v")
    pts4 = ec.mul_base(C, torch.cat([xr, v]))
    _eq(pts4[0], "X")
    _eq(pts4[1], "R")
    steps = torch.arange(2)[None, :, None].expand(2, 2, N)
    assert_same(nizk.gen_pokdlog_from(C, v, pts4[2:], pts4[:2], xr,
                                      IDS.expand(2, 2, N), steps), "r1_pok")
    Y = seal.avnet_keys_steps(C, g("X"))
    _eq(Y, "Y")
    _eq(seal._b01(C, Y, g("R"), xr[0]), "b01")


def _check_stage1_matches_jax():
    a = stage1_inputs()
    assert_same(nizk.gen_powfstage1_from(C, g("stage1_r"), **a), "stage1")


def _check_stage2_matches_jax():
    a = stage2_inputs()
    assert_same(nizk.gen_powfstage2_from(C, g("stage2_r"), **a), "stage2")


# One test per file: pytest-xdist (--dist loadfile) queues files by test
# count, and one-test files go last, after the long-running files of the
# tier-1 run have been handed out (see ROADMAP.md, Queue 3).
def test_generators_reproduce_jax_bytes():
    """Every generator of the board, fed the recorded JAX inputs and nonces."""
    _check_commit_board_and_pokdlogs_match_jax()
    _check_powfcom_matches_jax()
    _check_round_one_avnet_and_ciphertexts_match_jax()
    _check_stage1_matches_jax()
    _check_stage2_matches_jax()
