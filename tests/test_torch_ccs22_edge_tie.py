"""A CCS22 auction on the PyTorch port's CPU path for the three-way tie of
tests/test_ccs22.py's edge bids, fed the scalars the JAX driver drew
(tests/data/torch_golden_ccs22.npz), gives the JAX outcome and the
plaintext maximum."""

import torch

from torch_ccs22_cases import check_edge

torch.set_num_threads(1)


def test_ccs22_tied_bids_match_jax():
    check_edge(1)
