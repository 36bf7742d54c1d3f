"""The dual ladder at 64 windows on full scalars (plain version of the
`dual_mul` kernel, as the validator and a curve without GLV use it) against
the JAX package's Pallas kernel in interpret mode, its XLA path and
`host_curve`; cases in tests/torch_ladder64_cases.py."""

import torch

from torch_ladder64_cases import C, NO_GLV, check, g, same
from privacy_auction_tpu_torch.curves import COMB_WINDOWS
from privacy_auction_tpu_torch.ops import ec

torch.set_num_threads(1)


def test_dual_mul_64_windows_matches_jax_and_host():
    out = ec.dual_mul_windows_plain(C, g("P"), g("k"), g("Q"), g("t"),
                                    COMB_WINDOWS)
    check("dual_mul", out)
    same(ec.dual_mul(NO_GLV, g("P"), g("k"), g("Q"), g("t")), out)
