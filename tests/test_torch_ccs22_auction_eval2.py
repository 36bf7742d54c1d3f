"""A whole CCS22 auction on the PyTorch port's CPU path with the evaluator
at lane 2, the holder of the maximum bid, fed the scalars the JAX driver
drew (tests/data/torch_golden_ccs22.npz), gives the JAX package's setup
messages, per-step OT messages, announced bits and max bid."""

import torch

from torch_ccs22_cases import EVALS, check_auction

torch.set_num_threads(1)


def test_ccs22_auction_at_evaluator_2_matches_jax():
    check_auction(EVALS[1])
