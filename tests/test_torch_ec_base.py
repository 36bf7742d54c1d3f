"""The PyTorch port's GLV base_mul_add ladder (plain path of the GLV base
kernel) against JAX `ec.base_mul_add` on the CPU and `host_curve`, in affine
coordinates; cases in tests/torch_ec_cases.py."""

import torch

from torch_ec_cases import check_ladder

torch.set_num_threads(1)


def test_base_mul_add_matches_jax_and_host():
    check_ladder("base_mul_add")
