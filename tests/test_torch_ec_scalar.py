"""The PyTorch port's GLV scalar_mul (plain path of the 33-window dual
kernel) against JAX `ec.scalar_mul` on the CPU and `host_curve`; cases in
tests/torch_ec_cases.py."""

import torch

from torch_ec_cases import check_ladder

torch.set_num_threads(1)


def test_scalar_mul_matches_jax_and_host():
    check_ladder("scalar_mul")
