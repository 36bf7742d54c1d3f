"""g^s * P^t without GLV (plain version of the `base_mul_add` kernel, which
reads the same affine window-0 table of G) against the JAX package's Pallas
kernel in interpret mode, its XLA path and `host_curve`; cases in
tests/torch_ladder64_cases.py."""

import torch

from torch_ladder64_cases import C, NO_GLV, check, g, same
from privacy_auction_tpu_torch.ops import ec

torch.set_num_threads(1)


def test_base_mul_add_64_windows_matches_jax_and_host():
    out = ec.base_mul_add_plain(C, g("k"), g("P"), g("t"))
    check("base_mul_add", out)
    same(ec.base_mul_add(NO_GLV, g("k"), g("P"), g("t")), out)
