"""A tampered board aborts the port's metered SEAL loop at bids [5, 3, 6], c =
3, as tests/test_adversarial.py requires of the JAX package: the hook
publishes a Stage2 challenge ch2 with bit 0 flipped at step 1: ch1 + ch2 +
ch3 no longer equals the transcript's challenge. The auction returns
verified=False and max_bid=-1 at the check where the JAX loop stopped
(tests/data/torch_golden_metered.npz)."""

import torch

from torch_metered_cases import check_tamper

torch.set_num_threads(1)


def test_tampered_stage2_ch2_aborts(monkeypatch):
    check_tamper("stage2_ch2", monkeypatch)
