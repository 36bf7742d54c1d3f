"""The CUDA kernels on the card against their plain PyTorch versions on the
card, the kernel validator, and the JAX package's golden vectors (the
64-window ladders and a CCS22 auction, read with numpy alone) run through
the kernels.  Marked `cuda`; each test decides at run time whether a CUDA
device is present and skips where there is none.  On a machine with a card
(no JAX needed):

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_cuda.py
"""

import random

import pytest
import torch

from privacy_auction_tpu_torch.curves import COMB_WINDOWS, GLV_WINDOWS, SECP256K1 as C
from privacy_auction_tpu_torch.ops import cuda_ec, ec
from privacy_auction_tpu_torch.ops import field as F
from privacy_auction_tpu_torch.ops.validate import validate_kernels
from privacy_auction_tpu_torch.protocols import ccs22

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
    before = dict(cuda_ec.launches)
    full = [_scalars(rng, card, 256) for _ in range(2)]   # 64-window scalars
    full[0][9] = 0
    args = [t for P, k in zip(pts, ks) for t in (P, k)]
    flags = torch.randint(0, 2, (LANES, 2), device=card)
    if name == "mul_comb":
        table = C.tensor("comb_table", card)
        got, want = cuda_ec.mul_comb(table, ks[1]), ec.mul_comb_plain(C, table, ks[1])
    elif name == "dual_mul":
        got = cuda_ec.dual_mul(*args[:4], GLV_WINDOWS)
        want = ec.dual_mul_windows_plain(C, *args[:4], GLV_WINDOWS)
    elif name == "dual_mul_64":
        got = cuda_ec.dual_mul(pts[0], full[0], pts[1], full[1], COMB_WINDOWS)
        want = ec.dual_mul_windows_plain(C, pts[0], full[0], pts[1], full[1],
                                         COMB_WINDOWS)
    elif name == "scalar_mul":
        got = cuda_ec.scalar_mul(pts[0], full[0])
        want = ec.scalar_mul_windows_plain(C, pts[0], full[0])
    elif name == "base_mul_add":
        got = cuda_ec.base_mul_add(full[0], pts[0], full[1],
                                   C.tensor("g0_table", card))
        want = ec.base_mul_add_plain(C, full[0], pts[0], full[1])
    elif name == "pt_add":
        Q = pts[1].clone()
        Q[3] = pts[0][3]                             # P + P
        Q[4] = ec.neg(C, pts[0][4])                  # P + (-P)
        got, want = cuda_ec.pt_add(pts[0], Q), ec.add(C, pts[0], Q)
    elif name == "quad_mul":
        got = cuda_ec.quad_mul(*args, GLV_WINDOWS)
        want = ec.quad_mul_windows_plain(C, *args, GLV_WINDOWS)
    else:
        got = cuda_ec.base_mul_add_glv(*args[:4], ks[2], ks[3], flags,
                                       C.tensor("g0_tables", card), GLV_WINDOWS)
        want = ec.base_mul_add_glv_plain(C, *args[:4], ks[2], ks[3], flags,
                                         GLV_WINDOWS)
    torch.cuda.synchronize()
    assert cuda_ec.launches[name] == before[name] + 1
    assert torch.equal(got, want)


# One test per file: pytest-xdist (--dist loadfile) queues files by test
# count, and one-test files go last, after the long-running files of the
# tier-1 run have been handed out (see ROADMAP.md, Queue 3).
def _check_golden_on_card(card):
    """The JAX package's outputs, from the kernels on the card: the three
    64-window ladders and pt_add on the validator's edge lanes, CCS22's
    hoisted ladder passes, and a CCS22 auction's board at both recorded
    evaluators."""
    import torch_ccs22_cases as CC
    import torch_ladder64_cases as L

    def g(name):
        return L.g(name, card)

    outs = {
        "scalar_mul": cuda_ec.scalar_mul(g("P"), g("k")),
        "dual_mul": cuda_ec.dual_mul(g("P"), g("k"), g("Q"), g("t"),
                                     COMB_WINDOWS),
        "base_mul_add": cuda_ec.base_mul_add(g("k"), g("P"), g("t"),
                                             C.tensor("g0_table", card)),
        "pt_add": cuda_ec.pt_add(g("add.P"), g("add.Q")),
    }
    for name, out in outs.items():
        L.check(name, out)
    CC.assert_same(ccs22._precompute(C, ccs22.pp_or_make(C, card),
                                     CC.g(f"e{CC.EVALS[-1]}.setup_pub.X", card),
                                     CC.draws(device=card)), "pre")
    for eid in CC.EVALS:
        res = ccs22.run_auction(C, CC.BIDS, CC.C_BITS, eid, device=card,
                                draws=CC.draws(device=card))
        assert res.max_bid == int(CC.GOLD[f"e{eid}.max_bid"])
        CC.assert_same(res.board.setup, f"e{eid}.setup_pub")
        CC.assert_same(res.board.otr1, f"e{eid}.otr1")
        CC.assert_same(res.board.ots, f"e{eid}.ots")


def test_kernels_match_plain_and_host_on_card(card):
    """Each kernel against its plain version on the card, the validator's
    edge lanes against the host oracle, and the JAX golden vectors through
    the kernels."""
    for name in cuda_ec.KERNELS + ("dual_mul_64",):
        _check_kernel_matches_plain_on_card(card, name)
    validate_kernels(C, lanes=8, seed=1, device=card)
    _check_golden_on_card(card)
