"""The CUDA kernels on the card against their plain PyTorch versions on the
card, the kernel validator, and the JAX package's golden vectors (the
64-window ladders, a CCS22 auction and the SEAL proofs, read with numpy
alone) run through the kernels.  Marked `cuda`; each test decides at run time whether a CUDA
device is present and skips where there is none.  On a machine with a card
(no JAX needed):

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_cuda.py
"""

import random

import pytest
import torch

from privacy_auction_tpu_torch.curves import COMB_WINDOWS, GLV_WINDOWS, SECP256K1 as C
from privacy_auction_tpu_torch import nizk
from privacy_auction_tpu_torch.ops import cuda_ec, ec
from privacy_auction_tpu_torch.ops import field as F
from privacy_auction_tpu_torch.ops.validate import validate_kernels
from privacy_auction_tpu_torch.protocols import ccs22, seal

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
        got, want = cuda_ec.mul_comb(C, table, ks[1]), ec.mul_comb_plain(C, table, ks[1])
    elif name == "dual_mul":
        got = cuda_ec.dual_mul(C, *args[:4], GLV_WINDOWS)
        want = ec.dual_mul_windows_plain(C, *args[:4], GLV_WINDOWS)
    elif name == "dual_mul_64":
        got = cuda_ec.dual_mul(C, pts[0], full[0], pts[1], full[1], COMB_WINDOWS)
        want = ec.dual_mul_windows_plain(C, pts[0], full[0], pts[1], full[1],
                                         COMB_WINDOWS)
    elif name == "scalar_mul":
        got = cuda_ec.scalar_mul(C, pts[0], full[0])
        want = ec.scalar_mul_windows_plain(C, pts[0], full[0])
    elif name == "base_mul_add":
        got = cuda_ec.base_mul_add(C, full[0], pts[0], full[1],
                                   C.tensor("g0_table", card))
        want = ec.base_mul_add_plain(C, full[0], pts[0], full[1])
    elif name == "pt_add":
        Q = pts[1].clone()
        Q[3] = pts[0][3]                             # P + P
        Q[4] = ec.neg(C, pts[0][4])                  # P + (-P)
        got, want = cuda_ec.pt_add(C, pts[0], Q), ec.add(C, pts[0], Q)
    elif name == "quad_mul":
        got = cuda_ec.quad_mul(C, *args, GLV_WINDOWS)
        want = ec.quad_mul_windows_plain(C, *args, GLV_WINDOWS)
    else:
        got = cuda_ec.base_mul_add_glv(C, *args[:4], ks[2], ks[3], flags,
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
        "scalar_mul": cuda_ec.scalar_mul(C, g("P"), g("k")),
        "dual_mul": cuda_ec.dual_mul(C, g("P"), g("k"), g("Q"), g("t"),
                                     COMB_WINDOWS),
        "base_mul_add": cuda_ec.base_mul_add(C, g("k"), g("P"), g("t"),
                                             C.tensor("g0_table", card)),
        "pt_add": cuda_ec.pt_add(C, g("add.P"), g("add.Q")),
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


# --------------------------------------------------------------------------
# the group kernels (mul_comb, scalar_mul, dual_mul, quad_mul, base_mul_add,
# base_mul_add_glv: 8 or 4 threads a lane, mul_comb 8 or 2) at ragged lane
# counts, and against the JAX package
# --------------------------------------------------------------------------

GROUP_LANES = (1, 15, 17, 300, 2053)   # part of a block, ragged blocks
ALL_15 = (1 << 132) - 1           # every one of the 33 digits 15
ALL_15_FULL = (1 << 256) - 1      # every one of the 64 digits 15


def _group_inputs(card, lanes, seed):
    """Four points and four 132-bit scalars a lane, then two 256-bit
    scalars, with the edge lanes: an infinity input, zero scalars, all-15
    digits, and n-1 for the 256-bit scalars (lane 0 first, so each lane
    count has some)."""
    rng = random.Random(seed)

    def scalars(bits):
        return [rng.randrange(1 << bits) % C.host.n for _ in range(lanes)]

    pts = [ec.mul_base(C, torch.as_tensor(F.ints_to_limbs(scalars(256))).to(card))
           for _ in range(4)]
    ks = [scalars(132) for _ in range(4)] + [scalars(256) for _ in range(2)]
    edges = [(0, "all15"), (lanes - 1, "zero"), (lanes // 3, "n-1"),
             (lanes // 2, "inf")]
    for lane, what in edges:
        if what == "all15":
            for i, k in enumerate(ks):
                k[lane] = ALL_15 if i < 4 else ALL_15_FULL
        elif what == "zero":
            for i in (1, 3, 4):
                ks[i][lane] = 0
        elif what == "n-1":
            for i in (4, 5):
                ks[i][lane] = C.host.n - 1
    ks = [torch.as_tensor(F.ints_to_limbs(k)).to(card) for k in ks]
    pts[2][edges[-1][0]] = ec.infinity(card)
    return [t for P, k in zip(pts, ks) for t in (P, k)], ks[4:]


def test_group_kernels_match_plain_on_card(card):
    """The six group kernels equal their plain versions exactly at 1, 15,
    17, 300 and 2053 lanes, at both of their threads a lane and at
    launch_shape's own, edge lanes included: mul_comb on all-15, zero and
    n-1 scalars; scalar_mul, dual_mul at 33 and 64 windows and base_mul_add
    on an infinity input, zero and n-1 scalars and all-15 digits;
    base_mul_add_glv also with both sign flags set on one lane and each
    set alone on others."""
    g0b = C.tensor("g0_table", card)
    g0 = C.tensor("g0_tables", card)
    table = C.tensor("comb_table", card)
    for lanes in GROUP_LANES:
        args, full = _group_inputs(card, lanes, lanes)
        flags = torch.tensor([[1, 1], [1, 0], [0, 1], [0, 0]] * lanes,
                             device=card)[:lanes]
        glv = args[4:] + [args[1], args[3], flags]   # P1 t1 P2 t2 s1 s2 flags
        dual = args[4:6] + args[2:4]                 # P3 k3 P2 k2
        dual64 = [args[4], full[0], args[0], full[1]]
        bma = [full[1], args[4], full[0]]            # s P t
        cases = {
            "mul_comb": (lambda shape: cuda_ec.mul_comb(C, table, full[0], shape),
                         ec.mul_comb_plain(C, table, full[0])),
            "dual_mul": (lambda shape: cuda_ec.dual_mul(C, *dual, GLV_WINDOWS, shape),
                         ec.dual_mul_windows_plain(C, *dual, GLV_WINDOWS)),
            "dual_mul_64": (
                lambda shape: cuda_ec.dual_mul(C, *dual64, COMB_WINDOWS, shape),
                ec.dual_mul_windows_plain(C, *dual64, COMB_WINDOWS)),
            "scalar_mul": (
                lambda shape: cuda_ec.scalar_mul(C, args[4], full[0], shape=shape),
                ec.scalar_mul_windows_plain(C, args[4], full[0])),
            "base_mul_add": (
                lambda shape: cuda_ec.base_mul_add(C, *bma, g0b, shape),
                ec.base_mul_add_plain(C, *bma)),
            "quad_mul": (lambda shape: cuda_ec.quad_mul(C, *args, GLV_WINDOWS, shape),
                         ec.quad_mul_windows_plain(C, *args, GLV_WINDOWS)),
            "base_mul_add_glv": (
                lambda shape: cuda_ec.base_mul_add_glv(C, *glv, g0, GLV_WINDOWS, shape),
                ec.base_mul_add_glv_plain(C, *glv, GLV_WINDOWS)),
        }
        for name, (run, want) in cases.items():
            kernel = name.removesuffix("_64")
            before = dict(cuda_ec.launches)
            for group in cuda_ec.GROUPS[kernel]:
                got = run(cuda_ec.launch_shape(kernel, lanes, group=group))
                torch.cuda.synchronize()
                assert torch.equal(got, want), f"{name} at {lanes} lanes, G = {group}"
            assert cuda_ec.launches[name] == before[name] + 2
            assert torch.equal(run(None), want)         # launch_shape's own G


def _to(x, dev):
    if isinstance(x, dict):
        return {k: _to(v, dev) for k, v in x.items()}
    return x.to(dev) if isinstance(x, torch.Tensor) else x


def test_group_kernels_hold_jax_golden_on_card(card):
    """The JAX package's SEAL proofs from the group kernels: the recorded
    Stage1 and Stage2 proofs recomputed on the card from their recorded
    nonces (every equation through quad_mul), and the recorded round-1
    PoKDLogs verified by verify_round_one_batch (through
    base_mul_add_glv), with one tampered response rejected in its lane."""
    import torch_golden_cases as G

    def same(p, prefix):
        G.assert_same(type(p)(*[t.cpu() for t in p]), prefix)

    before = dict(cuda_ec.launches)
    same(nizk.gen_powfstage1_from(C, G.g("stage1_r").to(card),
                                  **_to(G.stage1_inputs(), card)), "stage1")
    same(nizk.gen_powfstage2_from(C, G.g("stage2_r").to(card),
                                  **_to(G.stage2_inputs(), card)), "stage2")
    assert cuda_ec.launches["quad_mul"] >= before["quad_mul"] + 2
    pok = G.proof(nizk.PoKDLog, "r1_pok")
    ids = G.IDS.to(card)
    pub = seal.RoundOnePub(G.g("X").to(card), G.g("R").to(card),
                           nizk.PoKDLog(pok.eps[0].to(card), pok.rho[0].to(card)),
                           nizk.PoKDLog(pok.eps[1].to(card), pok.rho[1].to(card)))
    assert bool(seal.verify_round_one_batch(C, pub, ids).all())
    bad = pub._replace(pok_r=pub.pok_r._replace(
        rho=G.tampered(pub.pok_r.rho, (1, 0))))
    want = torch.ones((2, G.N), dtype=torch.bool, device=card)
    want[1, 0] = False
    assert torch.equal(seal.verify_round_one_batch(C, bad, ids), want)
    assert cuda_ec.launches["base_mul_add_glv"] >= before["base_mul_add_glv"] + 2


def test_ladders64_group_kernels_hold_jax_golden_on_card(card):
    """scalar_mul and base_mul_add at both of their threads a lane
    reproduce the JAX package's Pallas outputs (and its XLA ladders and
    host_curve) limb for limb on the validator's edge lanes: scalars 0, 1
    and n-1, a point at infinity, a random lane."""
    import torch_ladder64_cases as L

    def g(name):
        return L.g(name, card)

    g0b = C.tensor("g0_table", card)
    lanes = g("k").shape[0]
    for name in ("scalar_mul", "base_mul_add"):
        before = cuda_ec.launches[name]
        for group in cuda_ec.GROUPS[name]:
            shape = cuda_ec.launch_shape(name, lanes, group=group)
            if name == "scalar_mul":
                out = cuda_ec.scalar_mul(C, g("P"), g("k"), shape=shape)
            else:
                out = cuda_ec.base_mul_add(C, g("k"), g("P"), g("t"), g0b, shape)
            L.check(name, out)
        assert cuda_ec.launches[name] == before + len(cuda_ec.GROUPS[name])


def test_sha256_kernel_and_ccs22_step_graph_on_card(card):
    """The SHA-256 kernel against its plain version on the card and
    against hashlib at block boundaries and ragged lane counts, one launch
    a call; then CCS22's steps replayed from one CUDA graph give the
    uncaptured steps' board, limb for limb, from the same draws."""
    import hashlib

    from privacy_auction_tpu_torch.ops import sha256 as S

    gen = torch.Generator().manual_seed(7)
    for length in (0, 55, 56, 64, 119, 1066):
        host = torch.randint(0, 256, (LANES, length), generator=gen,
                             dtype=torch.uint8)
        before = cuda_ec.launches["sha256"]
        got = S.sha256(host.to(card))
        assert cuda_ec.launches["sha256"] == before + 1
        assert torch.equal(got, S.sha256_plain(host.to(card)))
        for i in (0, 17, LANES - 1):
            want = hashlib.sha256(host[i].numpy().tobytes()).digest()
            assert got[i].tolist() == [int.from_bytes(want[4 * j:4 * j + 4], "big")
                                       for j in range(8)]
    n, c = 6, 4
    bids = [5, 9, 3, 12, 12, 0]
    draws = ccs22.draw(C, torch.Generator().manual_seed(8), n, c, card)
    res = ccs22.run_auction(C, bids, c, n - 1, device=card, draws=draws)
    assert res.max_bid == max(bids) and ccs22.last_graph["replays"] == c
    pp = ccs22.pp_or_make(C, card)
    pre = ccs22._precompute(C, pp, res.board.setup.X, draws)
    bits = torch.as_tensor(seal.bids_to_bits(bids, c), device=card)
    announced, r1, ots = ccs22._scan_steps(
        C, pre, pp.g1.expand(n, 3, F.LIMBS), bits,
        ccs22.eval_index(n - 1, card), graph=False)
    assert torch.equal(announced, res.board.announced)
    for a, b in zip(r1 + ots, res.board.otr1 + res.board.ots):
        assert torch.equal(a, b)
