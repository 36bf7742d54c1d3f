"""A CCS22 auction on the PyTorch port's CPU path for the all-zero edge bids
of tests/test_ccs22.py, where the evaluator never announces, fed the
scalars the JAX driver drew (tests/data/torch_golden_ccs22.npz), gives the
JAX outcome and the plaintext maximum.  The three-way tie is in
tests/test_torch_ccs22_edge_tie.py; the third edge case there, the
evaluator holding the max, is the auction of
tests/test_torch_ccs22_auction_eval2.py."""

import torch

from torch_ccs22_cases import check_edge

torch.set_num_threads(1)


def test_ccs22_edge_bids_match_jax():
    check_edge(0)
