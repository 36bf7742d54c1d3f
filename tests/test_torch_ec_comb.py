"""The PyTorch port's fixed-base comb ladder (plain path of the comb kernel)
against JAX `ec.mul_base` on the CPU and `host_curve`; cases in
tests/torch_ec_cases.py."""

import torch

from torch_ec_cases import check_ladder

torch.set_num_threads(1)


def test_mul_base_matches_jax_and_host():
    check_ladder("mul_base")
