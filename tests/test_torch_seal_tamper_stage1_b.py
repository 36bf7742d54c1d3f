"""A tampered board aborts the port's metered SEAL loop at bids [5, 3, 6], c =
3, as tests/test_adversarial.py requires of the JAX package: the hook
publishes the round-two ciphertext b of bidder 0 at step 0 (Stage1): not
the one its Stage1 proof binds. The auction returns verified=False and
max_bid=-1 at the check where the JAX loop stopped
(tests/data/torch_golden_metered.npz)."""

import torch

from torch_metered_cases import check_tamper

torch.set_num_threads(1)


def test_tampered_stage1_b_aborts(monkeypatch):
    check_tamper("stage1_b", monkeypatch)
