"""The honest control of the port's role-metered SEAL loop at bids [5, 3,
6], c = 3, with an identity tamper hook: it verifies, finds the maximum,
and matches the JAX package's metered loop (tests/data/
torch_golden_metered.npz) in deciding bits, bytes per category, the calls
the hook sees and the checks it runs; both roles accrue time.  The five
tamper cases are tests/test_torch_seal_tamper_*.py."""

import torch

from torch_metered_cases import check_honest

torch.set_num_threads(1)


def test_honest_control_matches_jax(monkeypatch):
    check_honest(monkeypatch)
