"""The 64-window scalar_mul (plain version of the `scalar_mul` kernel) and
the single add (plain version of `pt_add`) against the JAX package's Pallas
kernels in interpret mode, its XLA path and `host_curve`; cases in
tests/torch_ladder64_cases.py."""

import torch

from torch_ladder64_cases import C, NO_GLV, check, g, same
from privacy_auction_tpu_torch.ops import ec

torch.set_num_threads(1)


def test_scalar_mul_64_windows_and_pt_add_match_jax_and_host():
    out = ec.scalar_mul_windows_plain(C, g("P"), g("k"))
    check("scalar_mul", out)
    same(ec.scalar_mul(NO_GLV, g("P"), g("k")), out)   # the non-GLV dispatch
    check("pt_add", ec.add(C, g("add.P"), g("add.Q")))
    same(ec.pt_add(C, g("add.P"), g("add.Q")), ec.add(C, g("add.P"), g("add.Q")))
