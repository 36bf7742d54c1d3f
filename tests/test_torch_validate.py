"""The port's full kernel validator (`ops/validate.py`, the counterpart of
the JAX package's `validate_pallas_kernels`) passes on the plain versions:
the 64-window ladders, `mul_base`, the GLV dispatch and the single add, at
the edge lanes, against `host_curve`."""

import torch

from privacy_auction_tpu_torch.curves import SECP256K1 as C
from privacy_auction_tpu_torch.ops.validate import validate_kernels

torch.set_num_threads(1)


# One test per file: pytest-xdist (--dist loadfile) queues files by test
# count, and one-test files go last, after the long-running files of the
# tier-1 run have been handed out (see ROADMAP.md, Queue 3).
def test_validator_passes_on_the_plain_versions():
    validate_kernels(C, lanes=4, seed=2, device="cpu")
