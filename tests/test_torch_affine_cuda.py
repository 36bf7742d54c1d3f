"""The projective-to-affine kernel (`cuda_ec.to_affine`,
csrc/ec_affine.cu) on the card against the plain `ec.to_affine_plain` on
the card, limb for limb: eager and inside a captured CUDA graph, through
the SEC1 encoding and a Fiat-Shamir challenge, and in a fused SEAL
auction, whose step graphs replay its launches.  Marked `cuda`; each test
decides at run time whether a CUDA device is present and skips where there
is none.  On a machine with a card (no JAX needed):

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_affine_cuda.py
"""

import random

import pytest
import torch

from privacy_auction_tpu_torch import nizk
from privacy_auction_tpu_torch.curves import SECP256K1 as C
from privacy_auction_tpu_torch.ops import cuda_ec, ec
from privacy_auction_tpu_torch.ops import field as F
from privacy_auction_tpu_torch.protocols import seal

pytestmark = pytest.mark.cuda
# a lane, Stage1's and Stage2's challenges at SEAL 20x32 (300, 540), and
# wider launches
LANES = (1, 20, 300, 540, 1280, 4096)
AFFINE = cuda_ec.AFFINE


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _points(card, lanes, seed):
    """`lanes` points k*G from the comb, each scaled by a random Z (the same
    point, another representative), with the edge lanes: infinity (0:1:0)
    first, then where there are four lanes or more Z = 0 with X and Y set,
    Z = 1 and Z = p - 1."""
    rng = random.Random(seed)

    def below(bound):
        return torch.as_tensor(F.ints_to_limbs(
            [rng.randrange(1, bound) for _ in range(lanes)])).to(card)

    fp = C.fp
    P = ec.mul_base(C, below(C.host.n))
    P = F.mul(fp, P, below(C.host.p).unsqueeze(-2))
    P[0] = ec.infinity(card)
    if lanes >= 4:
        P[1, 2] = 0
        x, y = ec.to_affine_plain(C, P[2:4])
        P[2] = ec.from_affine(x[0], y[0])
        P[3] = torch.stack([F.neg(fp, x[1]), F.neg(fp, y[1]),
                            F.neg(fp, F.const(1, card))])
    return P


def _same(a, b):
    return all(torch.equal(u, v) for u, v in zip(a, b))


def test_to_affine_kernel_matches_plain_on_card(card):
    """At 1-4,096 lanes and on a (c, n, N) batch, edge lanes included
    (infinity gives (0, 0)): the kernel's x and y equal the plain
    version's limb for limb, one launch a call; so do the SEC1 encoding
    and a Fiat-Shamir challenge."""
    for lanes in LANES:
        P = _points(card, lanes, lanes)
        before = cuda_ec.launches[AFFINE]
        got = cuda_ec.to_affine(C, P)
        torch.cuda.synchronize()
        assert cuda_ec.launches[AFFINE] == before + 1
        assert _same(got, ec.to_affine_plain(C, P)), f"{lanes} lanes"
        if lanes >= 4:
            assert not torch.cat(got)[[0, 1, lanes, lanes + 1]].any()
    batch = _points(card, 2 * 5 * 7, 7).reshape(2, 5, 7, 3, F.LIMBS)
    got = ec.to_affine(C, batch)
    assert got[0].shape == (2, 5, 7, F.LIMBS)
    assert _same(got, ec.to_affine_plain(C, batch))

    pts = [_points(card, 20, s) for s in (1, 2, 3)]
    ids = torch.arange(20, device=card)
    before = cuda_ec.launches[AFFINE]
    enc = ec.serialize_uncompressed(C, pts[0])
    ch = nizk.fs_challenge(C, pts, ids, b"affine", steps=3)
    assert cuda_ec.launches[AFFINE] == before + 2
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ec, "to_affine", ec.to_affine_plain)
        assert torch.equal(enc, ec.serialize_uncompressed(C, pts[0]))
        assert torch.equal(ch, nizk.fs_challenge(C, pts, ids, b"affine",
                                                 steps=3))
    assert cuda_ec.launches[AFFINE] == before + 2


def test_to_affine_kernel_in_a_cuda_graph(card):
    """Captured into a CUDA graph, the launch is recorded once, and a
    replay on new points in the captured buffer gives the plain version's
    result."""
    lanes = 540
    static = _points(card, lanes, 11)
    fresh = _points(card, lanes, 12)
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with cuda_ec.recorded(), torch.cuda.stream(side):
        cuda_ec.to_affine(C, static)
    torch.cuda.current_stream(card).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with cuda_ec.recorded() as seen, torch.cuda.graph(graph):
        out = cuda_ec.to_affine(C, static)
    assert seen == {(AFFINE, lanes): 1}
    static.copy_(fresh)
    graph.replay()
    torch.cuda.synchronize()
    assert _same(out, ec.to_affine_plain(C, fresh))


def _boards_equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if a is None or b is None:
        return a is None and b is None
    return len(a) == len(b) and all(_boards_equal(x, y) for x, y in zip(a, b))


def test_seal_step_graphs_launch_the_kernel_on_card(card):
    """A verified fused SEAL auction at 4x8 converts with the kernel: 6
    eager launches (the commitment's PoKDLogs and PoWFCom and their check,
    round one's PoKDLogs and their check) and 2 a step (a proof and its
    check), counted at the graphs' replays; its board equals the plain
    conversion's, and its two step graphs hold fewer than a fifth of the
    kernel nodes they hold with the plain conversion."""
    n, c = 4, 8
    bids = [200, 131, 7, 255 - 64]      # bidder 0 decides the first bit
    runs = {}
    for kind in ("kernel", "plain"):
        with pytest.MonkeyPatch.context() as mp:
            if kind == "plain":
                mp.setattr(ec, "to_affine", ec.to_affine_plain)
            cuda_ec.reset_launches()
            res = seal.run_auction(C, bids, c, verify=True,
                                   generator=torch.Generator().manual_seed(16),
                                   device=card)
            runs[kind] = (res, dict(cuda_ec.launch_lanes),
                          {k: dict(g) for k, g in seal.last_graphs.items()})
    (res, lanes, graphs), (plain, plain_lanes, plain_graphs) = (
        runs["kernel"], runs["plain"])
    assert res.verified and res.max_bid == max(bids)
    assert plain.verified and plain.max_bid == res.max_bid
    assert res.deciding_bits.tolist() == plain.deciding_bits.tolist()
    assert _boards_equal(res.board, plain.board)
    steps = {"stage1": 1, "stage2": c - 1}
    assert {k: g["replays"] for k, g in graphs.items()} == steps
    want = {(AFFINE, 4 * n * c): 4, (AFFINE, 7 * n * c): 2,
            (AFFINE, 15 * n): 2 * steps["stage1"],
            (AFFINE, 27 * n): 2 * steps["stage2"]}
    assert {k: v for k, v in lanes.items() if k[0] == AFFINE} == want
    assert not any(k[0] == AFFINE for k in plain_lanes)
    for stage in steps:
        assert graphs[stage]["launches"][(AFFINE, (15 if stage == "stage1"
                                                   else 27) * n)] == 2
        assert graphs[stage]["kernels"] < 0.2 * plain_graphs[stage]["kernels"], (
            stage, graphs[stage]["kernels"], plain_graphs[stage]["kernels"])
