"""The PyTorch port's GLV dual_mul (plain path of the quad kernel) against
JAX `ec.dual_mul` on the CPU and `host_curve`; cases in
tests/torch_ec_cases.py."""

import torch

from torch_ec_cases import check_ladder

torch.set_num_threads(1)


def test_dual_mul_matches_jax_and_host():
    check_ladder("dual_mul")
