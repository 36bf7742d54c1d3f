"""The CUDA ladder kernels on the card against their plain PyTorch versions
on the card, and the kernel validator.  Marked `cuda`; each test decides at
run time whether a CUDA device is present and skips where there is none.
On a machine with a card (no JAX needed):

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_cuda.py
"""

import random

import pytest
import torch

from privacy_auction_tpu_torch.curves import GLV_WINDOWS, SECP256K1 as C
from privacy_auction_tpu_torch.ops import cuda_ec, ec
from privacy_auction_tpu_torch.ops import field as F
from privacy_auction_tpu_torch.ops.validate import validate_kernels

pytestmark = pytest.mark.cuda
LANES = 300   # more than two blocks of 128 threads, with a ragged edge


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _scalars(rng, dev, bits):
    ks = [rng.randrange(1 << bits) % C.host.n for _ in range(LANES)]
    return torch.as_tensor(F.ints_to_limbs(ks)).to(dev)


def _check_kernel_matches_plain_on_card(card, name):
    rng = random.Random(name)
    pts = [ec.mul_base(C, _scalars(rng, card, 256)) for _ in range(4)]
    pts[0][5] = ec.infinity(card)                  # an infinity input lane
    ks = [_scalars(rng, card, 132) for _ in range(4)]
    ks[0][7] = 0
    args = [t for P, k in zip(pts, ks) for t in (P, k)]
    flags = torch.randint(0, 2, (LANES, 2), device=card)
    before = cuda_ec.launches[name]
    if name == "mul_comb":
        table = C.tensor("comb_table", card)
        got, want = cuda_ec.mul_comb(table, ks[1]), ec.mul_comb_plain(C, table, ks[1])
    elif name == "dual_mul":
        got = cuda_ec.dual_mul(*args[:4], GLV_WINDOWS)
        want = ec.dual_mul_windows_plain(C, *args[:4], GLV_WINDOWS)
    elif name == "quad_mul":
        got = cuda_ec.quad_mul(*args, GLV_WINDOWS)
        want = ec.quad_mul_windows_plain(C, *args, GLV_WINDOWS)
    else:
        got = cuda_ec.base_mul_add_glv(*args[:4], ks[2], ks[3], flags,
                                       C.tensor("g0_tables", card), GLV_WINDOWS)
        want = ec.base_mul_add_glv_plain(C, *args[:4], ks[2], ks[3], flags,
                                         GLV_WINDOWS)
    torch.cuda.synchronize()
    assert cuda_ec.launches[name] == before + 1
    assert torch.equal(got, want)


# One test per file: pytest-xdist (--dist loadfile) queues files by test
# count, and one-test files go last, after the long-running files of the
# tier-1 run have been handed out (see ROADMAP.md, Queue 3).
def test_kernels_match_plain_and_host_on_card(card):
    """Each kernel against its plain version on the card, then the
    validator's edge lanes against the host oracle."""
    for name in cuda_ec.KERNELS:
        _check_kernel_matches_plain_on_card(card, name)
    validate_kernels(C, lanes=8, seed=1, device=card)
