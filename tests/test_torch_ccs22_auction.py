"""A whole CCS22 auction on the PyTorch port's CPU path with the evaluator
at lane 0, fed the scalars the JAX driver drew
(tests/data/torch_golden_ccs22.npz, written by tools/torch_golden.py),
gives the JAX package's setup messages, per-step OT messages, announced
bits and max bid.  Evaluator 2 is in tests/test_torch_ccs22_auction_eval2.py,
the edge bids in tests/test_torch_ccs22_edge*.py."""

import torch

from torch_ccs22_cases import EVALS, check_auction

torch.set_num_threads(1)


def test_ccs22_auction_matches_jax():
    check_auction(EVALS[0])
