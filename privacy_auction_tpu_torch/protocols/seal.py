"""SEAL protocol: sealed-bid first-price auction without auctioneers, in
PyTorch.

Counterpart of `privacy_auction_tpu/protocols/seal.py`, with both of its
drivers.  The fused driver (`run_auction`'s default path): commit, commit
verification, the hoisted state-independent passes for all c steps
(round-1 keygens and their PoKDLog checks, AV-net keys, both ciphertext
candidates), then the c auction steps.  Each step generates and verifies a
Stage1 or Stage2 proof (one ladder pass each) and runs the round-3 veto
sum.  The role-metered driver (`_run_metered`, with `times` or `tamper`):
one call a round and step, each prover call timed as bidder time and each
check as verifier time, the messages passed through a board hook, and the
first failed check ending the auction.

The steps are host loops.  Stage selection branches on the public
junction flag, read with one `.item()` per step; the per-bidder work stays
branchless.  Every call is one batched computation over all n bidders
(and all c bits or steps where the phase allows).

Randomness comes from one `torch.Generator`, drawn in a fixed order that
both drivers share; a CPU generator gives the same nonces on every device.

Both drivers run on a bidder mesh (`run_auction(mesh=...)`,
`parallel/mesh.py`): each rank holds a contiguous block of the bidders'
rows and runs every lane-local phase on them (commit, proofs, checks,
ciphertexts, the ladders at n/D lanes).  The protocol crosses bidders in
two places, where the rank gathers the rows of all ranks: the AV-net
prefix scan and the round-three veto sum, each through the same
Hillis-Steele tree on every rank; every check's flag is ANDed over the
ranks.  A rank draws every nonce of all n lanes, in the unsharded order,
and keeps its rows (`field.Rows`), so the published board is the unsharded
run's, bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import nizk
from ..curves import Curve
from ..ops import ec
from ..ops import field as F
from ..parallel import mesh as M
from .phases import phase_runner

LIMBS = F.LIMBS


# --------------------------------------------------------------------------
# message types (struct-of-arrays over the bidder axis)
# --------------------------------------------------------------------------

class CommitmentPub(NamedTuple):
    phi: torch.Tensor   # (n, c, 3, L)  g^(alpha*beta + bit)
    A: torch.Tensor     # (n, c, 3, L)  g^alpha
    B: torch.Tensor     # (n, c, 3, L)  g^beta
    pok_a: nizk.PoKDLog
    pok_b: nizk.PoKDLog
    powf: nizk.PoWFCom


class CommitmentSec(NamedTuple):
    alpha: torch.Tensor  # (n, c, L)
    beta: torch.Tensor   # (n, c, L)


class RoundOnePub(NamedTuple):
    """Round-1 keys and their PoKDLogs: fields (n, ...) at one step, or
    (c, n, ...) for all steps."""

    X: torch.Tensor  # g^x
    R: torch.Tensor  # g^r
    pok_x: nizk.PoKDLog
    pok_r: nizk.PoKDLog


class RoundOneSec(NamedTuple):
    x: torch.Tensor  # (n, L) or (c, n, L)
    r: torch.Tensor


class RoundTwoPub(NamedTuple):
    """A step's ciphertexts and stage proof; exactly one of proof1 (Stage1,
    before the junction) and proof2 (Stage2, after it) is set."""

    b: torch.Tensor  # (n, 3, L)
    proof1: nizk.PoWFStage1 | None
    proof2: nizk.PoWFStage2 | None


class StepInfo(NamedTuple):
    """One deciding step's state, the previous-step context of Stage2."""

    X: torch.Tensor   # (n, 3, L)
    R: torch.Tensor   # (n, 3, L)
    Y: torch.Tensor   # (n, 3, L)
    b: torch.Tensor   # (n, 3, L)
    x: torch.Tensor   # (n, L)   secret key (prover side only)
    d: torch.Tensor   # (n,)     effective encoded bit


class Board(NamedTuple):
    """Every message an auction published, as the verifiers read them."""

    commit: CommitmentPub
    round1: RoundOnePub          # fields (c, n, ...)
    round2: tuple                # one RoundTwoPub a step


class AuctionResult(NamedTuple):
    max_bid: int
    verified: bool
    deciding_bits: np.ndarray  # (c,) uint8
    board: Board | None = None  # None when a check failed


# Maximum supported bid bit-length (the JAX package's C_MAX).
C_MAX = 64


def bids_to_bits(bids, c: int) -> np.ndarray:
    """Host: integer bids (n,) -> (n, c) bit matrix, MSB first.  Raises if c
    is out of [1, C_MAX] or a bid does not fit in c bits."""
    if not 1 <= c <= C_MAX:
        raise ValueError(f"bid bit-length c={c} out of range [1, {C_MAX}]")
    blist = [int(b) for b in bids]
    bad = [b for b in blist if b < 0 or b >= (1 << c)]
    if bad:
        raise ValueError(f"bids {bad[:4]}{'...' if len(bad) > 4 else ''} do "
                         f"not fit in c={c} bits")
    return np.array([[(b >> (c - 1 - i)) & 1 for i in range(c)] for b in blist],
                    dtype=np.int64).reshape(len(blist), c)


def _split(pok: nizk.PoKDLog):
    return (nizk.PoKDLog(pok.eps[0], pok.rho[0]),
            nizk.PoKDLog(pok.eps[1], pok.rho[1]))


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def commit(curve: Curve, generator, bid_bits, ids):
    """Commit phase for all (bidder, bit): phi = g^(alpha*beta + bit),
    A = g^alpha, B = g^beta, PoKDLog(A), PoKDLog(B), PoWFCom; the bit index
    is bound into every transcript.  bid_bits (n, c) in {0,1}, MSB first."""
    fn = curve.fn
    n, c = bid_bits.shape
    dev = bid_bits.device
    alpha, beta = F.random(fn, generator, (2, n, c), dev)
    v = F.random(fn, generator, (2, n, c), dev)
    bit_limbs = torch.zeros((n, c, LIMBS), dtype=F.DTYPE, device=dev)
    bit_limbs[..., 0] = bid_bits
    exp_phi = F.add(fn, F.mul(fn, alpha, beta), bit_limbs)
    pts = ec.mul_base(curve, torch.stack([exp_phi, alpha, beta, v[0], v[1]]))
    phi, A, B = pts[0], pts[1], pts[2]
    ids_nc = ids[:, None].expand(n, c)
    steps_nc = torch.arange(c, device=dev).expand(n, c)
    pok_a, pok_b = _split(nizk.gen_pokdlog_from(
        curve, v, pts[3:5], torch.stack([A, B]), torch.stack([alpha, beta]),
        ids_nc.expand(2, n, c), steps_nc.expand(2, n, c)))
    powf = nizk.gen_powfcom(curve, generator, phi, A, B, alpha, bid_bits,
                            ids_nc, steps_nc)
    return (CommitmentPub(phi=phi, A=A, B=B, pok_a=pok_a, pok_b=pok_b,
                          powf=powf),
            CommitmentSec(alpha=alpha, beta=beta))


def verify_commit(curve: Curve, pub: CommitmentPub, ids):
    """Verify every commitment proof once -> (n, c) bool."""
    n, c = pub.phi.shape[:2]
    ids_nc = ids[:, None].expand(n, c)
    steps_nc = torch.arange(c, device=ids.device).expand(n, c)
    return nizk.ver_commit_phase(curve, pub.pok_a, pub.pok_b, pub.powf,
                                 pub.phi, pub.A, pub.B, ids_nc, steps_nc)


def draw_round_one(curve: Curve, generator, n: int, c: int, device):
    """All c steps' round-1 scalars, in the order both drivers draw them:
    the keys xr = (x, r) and then the Schnorr nonces v, each (2, c, n, L)."""
    xr = F.random(curve.fn, generator, (2, c, n), device, bidder_dim=2)
    return xr, F.random(curve.fn, generator, (2, c, n), device, bidder_dim=2)


def round_one_from(curve: Curve, xr, v, ids, steps):
    """Round-1 keys X = g^x, R = g^r and their PoKDLogs from the keys
    xr (2, ..., L) and nonces v (2, ..., L), in one fixed-base pass over
    the keys and nonce commitments; the step index (an int, or a tensor
    broadcast to xr's batch) is bound into both transcripts.  ids (n,)."""
    pts4 = ec.mul_base(curve, torch.cat([xr, v], dim=0))
    pts, eps = pts4[:2], pts4[2:]
    pok_x, pok_r = _split(nizk.gen_pokdlog_from(
        curve, v, eps, pts, xr, ids.expand(xr.shape[:-1]), steps))
    return (RoundOnePub(X=pts[0], R=pts[1], pok_x=pok_x, pok_r=pok_r),
            RoundOneSec(x=xr[0], r=xr[1]))


def verify_round_one(curve: Curve, pub: RoundOnePub, ids, steps):
    """Both PoKDLogs of every party in one pass -> bool over pub.X's batch."""
    ok = nizk.ver_pokdlog(
        curve,
        nizk.PoKDLog(torch.stack([pub.pok_x.eps, pub.pok_r.eps]),
                     torch.stack([pub.pok_x.rho, pub.pok_r.rho])),
        torch.stack([pub.X, pub.R]), ids.expand((2,) + pub.X.shape[:-2]),
        steps)
    return ok[0] & ok[1]


def _all_steps(c: int, n: int, device):
    return torch.arange(c, device=device)[None, :, None].expand(2, c, n)


def round_one_batch(curve: Curve, generator, n: int, c: int, ids):
    """Round-1 keys and PoKDLogs for all c steps in one pass (they do not
    depend on the auction state).  Leading axes (c, n)."""
    xr, v = draw_round_one(curve, generator, n, c, ids.device)
    return round_one_from(curve, xr, v, ids, _all_steps(c, n, ids.device))


def verify_round_one_batch(curve: Curve, pub: RoundOnePub, ids):
    """All c steps' round-1 proofs verified in one pass -> (c, n) bool."""
    c, n = pub.X.shape[:2]
    return verify_round_one(curve, pub, ids, _all_steps(c, n, ids.device))


def avnet_keys(curve: Curve, X):
    """Y_i = sum_{j<i} X_j - sum_{j>i} X_j along the party axis 0 (any
    trailing batch axes): from one inclusive prefix scan P (the JAX
    package's tree) and the total S = P_n, Y_i = 2 P_i - X_i - S."""
    P = ec.ec_prefix_scan(curve, X, dim=0)
    S = P[-1:]
    neg_part = ec.neg(curve, ec.add(curve, X, S.expand(X.shape)))
    return ec.add(curve, ec.add(curve, P, P), neg_part)


def avnet_keys_steps(curve: Curve, X):
    """`avnet_keys` for all steps at once: X (c, n, 3, L) -> (c, n, 3, L)."""
    return avnet_keys(curve, X.movedim(1, 0)).movedim(0, 1)


def avnet_rows(curve: Curve, X, mesh=None, dim: int = 0):
    """The AV-net keys of this rank's rows of X, whose bidder axis is
    `dim`: X gathered from every rank, the scan over all n bidders (the
    same tree on every rank), the rank's rows kept.  Without a mesh,
    `avnet_keys` along `dim`."""
    full = M.gather_bidders(mesh, X, dim)
    Y = avnet_keys(curve, full.movedim(dim, 0)).movedim(0, dim)
    return M.shard_bidders(mesh, Y, dim)


def _b01(curve: Curve, Y, R, x):
    """Both ciphertext candidates Y^x / R^x: Y, R (..., 3, L), x (..., L)
    -> (2, ..., 3, L)."""
    return ec.scalar_mul(curve, torch.stack([Y, R]), x.expand((2,) + x.shape))


def _ciphertext(curve: Curve, Y, R, x, d):
    """A step's ciphertexts b = Y^x (d = 0) | R^x (d = 1), computed inside
    the step: one scalar-mult pass over its 2n lanes, then a select."""
    b0, b1 = _b01(curve, Y, R, x)
    return ec.select(d == 0, b0, b1)


def round_two_stage1(curve: Curve, generator, sec: RoundOneSec,
                     pub: RoundOnePub, Y, commit_pub: CommitmentPub,
                     commit_sec: CommitmentSec, d, ids, step: int, b=None):
    """Round 2 before the junction: the ciphertexts (computed here unless
    given) and their Stage1 proof.  sec, pub: this step's round-1 secrets
    and keys; Y: its AV-net keys; d (n,): the effective bits.  Returns
    (RoundTwoPub, StepInfo)."""
    if b is None:
        b = _ciphertext(curve, Y, pub.R, sec.x, d)
    proof = nizk.gen_powfstage1(
        curve, generator, pub.X, Y, pub.R, commit_pub.phi[:, step],
        commit_pub.A[:, step], commit_pub.B[:, step], sec.x,
        commit_sec.alpha[:, step], d, ids, step, b)
    return (RoundTwoPub(b=b, proof1=proof, proof2=None),
            StepInfo(X=pub.X, R=pub.R, Y=Y, b=b, x=sec.x, d=d))


def _stage2_points(pub: RoundOnePub, Y, commit_pub: CommitmentPub,
                   prev: StepInfo, step: int):
    return dict(Xi=pub.X, Ri=pub.R, Yi=Y, Bj=prev.b, Xj=prev.X, Rj=prev.R,
                Yj=prev.Y, Ci=commit_pub.phi[:, step], A=commit_pub.A[:, step],
                B=commit_pub.B[:, step])


def round_two_stage2(curve: Curve, generator, sec: RoundOneSec,
                     pub: RoundOnePub, Y, commit_pub: CommitmentPub,
                     commit_sec: CommitmentSec, d, prev: StepInfo, ids,
                     step: int, b=None):
    """Round 2 after the junction: the ciphertexts and their Stage2 proof
    against prev, the last deciding step (its x and d are the prover's
    own secrets).  Returns (RoundTwoPub, StepInfo)."""
    if b is None:
        b = _ciphertext(curve, Y, pub.R, sec.x, d)
    proof = nizk.gen_powfstage2(
        curve, generator, _stage2_points(pub, Y, commit_pub, prev, step),
        sec.x, prev.x, commit_sec.alpha[:, step], d, prev.d, ids, step, b)
    return (RoundTwoPub(b=b, proof1=None, proof2=proof),
            StepInfo(X=pub.X, R=pub.R, Y=Y, b=b, x=sec.x, d=d))


def verify_round_two_stage1(curve: Curve, pub2: RoundTwoPub,
                            pub1: RoundOnePub, Y, commit_pub: CommitmentPub,
                            ids, step: int):
    """-> (n,) bool."""
    return nizk.ver_powfstage1(
        curve, pub2.proof1, pub2.b, pub1.X, Y, pub1.R,
        commit_pub.phi[:, step], commit_pub.A[:, step],
        commit_pub.B[:, step], ids, step)


def verify_round_two_stage2(curve: Curve, pub2: RoundTwoPub,
                            pub1: RoundOnePub, Y, commit_pub: CommitmentPub,
                            prev: StepInfo, ids, step: int):
    """-> (n,) bool."""
    pts = dict(_stage2_points(pub1, Y, commit_pub, prev, step), Bi=pub2.b)
    return nizk.ver_powfstage2(curve, pub2.proof2, pts, ids, step)


def round_three(curve: Curve, b, mesh=None):
    """Veto aggregation: True iff sum_j b_j != infinity, i.e. the max-bid
    bit at this step is 1; b holds this rank's rows, gathered from every
    rank on a mesh.  Returns a () bool tensor."""
    return ~ec.is_infinity(ec.ec_sum(curve, M.gather_bidders(mesh, b), dim=0))


# --------------------------------------------------------------------------
# drivers
# --------------------------------------------------------------------------

def _at(tree, i):
    """Entry i along the leading axis of every tensor of a (nested)
    NamedTuple."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return type(tree)(*(_at(t, i) for t in tree))


def _stack(trees):
    """The (nested) NamedTuples of `trees` stacked along a new axis 0."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    return type(first)(*(_stack(list(f)) for f in zip(*trees)))


def bits_to_int(deciding) -> int:
    """Deciding bits, most significant first -> the max bid."""
    max_bid = 0
    for bit in deciding:
        max_bid = (max_bid << 1) | int(bit)
    return max_bid


class Precomputed(NamedTuple):
    """The state-independent streams of all c steps (leading axis c)."""

    pub1: RoundOnePub
    sec1: RoundOneSec
    Y: torch.Tensor     # (c, n, 3, L)
    b0: torch.Tensor    # (c, n, 3, L) Y^x
    b1: torch.Tensor    # (c, n, 3, L) R^x


def run_steps(curve: Curve, generator, pre: Precomputed, bits, ids,
              commit_pub: CommitmentPub, commit_sec: CommitmentSec,
              verify: bool, mesh=None):
    """The fused driver's c auction steps, most significant bit first, on
    this rank's rows.  Returns (deciding (c,) list of bool, ok () bool
    tensor of this rank's checks, the steps' RoundTwoPub)."""
    n, c = bits.shape
    in_race = torch.ones((n,), dtype=F.DTYPE, device=bits.device)
    junction = False
    prev = None
    ok = torch.ones((), dtype=torch.bool, device=bits.device)
    deciding, round2 = [], []
    for s in range(c):
        d = bits[:, s] & in_race
        b = ec.select(d == 0, pre.b0[s], pre.b1[s])
        pub1, sec1, Y = _at(pre.pub1, s), _at(pre.sec1, s), pre.Y[s]
        if not junction:
            pub2, info = round_two_stage1(curve, generator, sec1, pub1, Y,
                                          commit_pub, commit_sec, d, ids, s, b)
            if verify:
                ok = ok & verify_round_two_stage1(curve, pub2, pub1, Y,
                                                  commit_pub, ids, s).all()
        else:
            pub2, info = round_two_stage2(curve, generator, sec1, pub1, Y,
                                          commit_pub, commit_sec, d, prev,
                                          ids, s, b)
            if verify:
                ok = ok & verify_round_two_stage2(curve, pub2, pub1, Y,
                                                  commit_pub, prev, ids,
                                                  s).all()
        round2.append(pub2)
        step_deciding = bool(round_three(curve, b, mesh).item())
        deciding.append(step_deciding)
        if step_deciding:
            prev = info
            in_race = in_race & d
            junction = True
    return deciding, ok, tuple(round2)


def _run_metered(curve: Curve, generator, bits, ids, verify: bool, phase,
                 trackers, tamper, mesh=None) -> AuctionResult:
    """The host loop of one call a round, as the JAX package's
    `run_auction` runs it for per-role times and the tamper hook: each
    prover call is bidder time, each check verifier time, and the first
    failed check ends the auction.  `tamper(phase, step, pub)` gives what
    lands on the board for "commit", "round1" and "round2"; the verifiers
    and round 3 read the board, the honest provers their own values.  On a
    mesh the hook sees the whole message, gathered from every rank, and
    each rank reads its rows of what it returns.  The nonces are drawn in
    the fused driver's order."""
    from ..utils.trackers import CATEGORY_BIDDER, CATEGORY_VERIFIER

    n, c = bits.shape
    n_all = n * M.mesh_size(mesh)
    failed = AuctionResult(max_bid=-1, verified=False,
                           deciding_bits=np.zeros(c, np.uint8))

    def board(name, step, pub):
        if tamper is None:
            return pub
        whole = M.gather_bidders(mesh, pub)
        out = tamper(name, step, whole)
        return pub if out is whole else M.shard_bidders(mesh, out)

    def bidder(name, fn, *args):
        return phase(name, fn, *args, role=CATEGORY_BIDDER)

    def checked(name, fn, *args):
        """Runs a check as verifier time: True when it passed or verify is
        off."""
        if not verify:
            return True
        return M.all_true(mesh, phase(name, fn, *args, role=CATEGORY_VERIFIER))

    commit_pub, commit_sec = bidder("commit", commit, curve, generator, bits,
                                    ids)
    board_commit = board("commit", None, commit_pub)
    if not checked("verify_commit", verify_commit, curve, board_commit, ids):
        return failed
    if trackers is not None:
        trackers.account_commit(n_all, c)

    xr, v = draw_round_one(curve, generator, n, c, bits.device)
    in_race = torch.ones((n,), dtype=F.DTYPE, device=bits.device)
    junction = False
    prev = None
    deciding, round1, round2 = np.zeros(c, np.uint8), [], []
    for step in range(c):
        pub1, sec1 = bidder("round_one", round_one_from, curve, xr[:, step],
                            v[:, step], ids, step)
        board_pub1 = board("round1", step, pub1)
        if not checked("verify_round_one", verify_round_one, curve,
                       board_pub1, ids, step):
            return failed
        d = bits[:, step] & in_race
        Y = bidder("avnet", avnet_rows, curve, pub1.X, mesh)
        board_Y = (Y if board_pub1 is pub1
                   else avnet_rows(curve, board_pub1.X, mesh))
        if not junction:
            pub2, info = bidder("round_two", round_two_stage1, curve,
                                generator, sec1, pub1, Y, commit_pub,
                                commit_sec, d, ids, step)
            board_pub2 = board("round2", step, pub2)
            ok = checked("verify_round_two", verify_round_two_stage1, curve,
                         board_pub2, board_pub1, board_Y, board_commit, ids,
                         step)
        else:
            pub2, info = bidder("round_two", round_two_stage2, curve,
                                generator, sec1, pub1, Y, commit_pub,
                                commit_sec, d, prev, ids, step)
            board_pub2 = board("round2", step, pub2)
            ok = checked("verify_round_two", verify_round_two_stage2, curve,
                         board_pub2, board_pub1, board_Y, board_commit, prev,
                         ids, step)
        if not ok:
            return failed
        if trackers is not None:
            trackers.account_step(n_all, stage2=junction)
        round1.append(board_pub1)
        round2.append(board_pub2)
        step_deciding = bool(bidder("round_three", round_three, curve,
                                    board_pub2.b, mesh).item())
        deciding[step] = step_deciding
        if step_deciding:
            in_race = in_race & d
            junction = True
            prev = info
    return AuctionResult(max_bid=bits_to_int(deciding), verified=True,
                         deciding_bits=deciding,
                         board=_gather_board(mesh, board_commit,
                                             _stack(round1), tuple(round2)))


def _gather_board(mesh, commit_pub, round1, round2) -> Board:
    """The whole board from this rank's rows (round one's bidder axis is
    dim 1)."""
    commit_pub, round2 = M.gather_bidders(mesh, (commit_pub, round2))
    return Board(commit=commit_pub, round1=M.gather_bidders(mesh, round1, 1),
                 round2=round2)


def run_auction(curve: Curve, bids, c: int, verify: bool = True,
                generator: torch.Generator | None = None, device="cuda",
                phase_times: dict | None = None, times=None, trackers=None,
                tamper=None, mesh=None) -> AuctionResult:
    """Full SEAL auction for integer bids.  A failed verification gives
    verified=False and max_bid=-1, as in the JAX package.

    The fused driver (the default) runs commit, its check, the hoisted
    passes of all c steps, then the steps.  With `times` or `tamper` the
    host loop of one call a round runs instead (`_run_metered`); from the
    same generator both publish the same board and draw the same nonces.

    generator: the source of every nonce (a fresh, OS-seeded CPU generator
    when None; on a mesh rank 0 draws its seed and every rank takes it).
    Like the JAX package's PRNG keys, it is not a cryptographic generator.
    phase_times: optional dict; each phase's wall time in seconds, taken
    after a device synchronize, is added under the phase's name.  Each
    phase runs in a `torch.profiler` range named `seal.<phase>`.
    times: optional `utils.trackers.TimeTracker`: prover calls accrue to
    the "bidder" category (one batched call serves all n bidders, so one
    bidder's time is the total / n), checks to "verifier" (each proof is
    checked once, one reference verifier's work).  On a mesh both are this
    rank's times.
    trackers: optional `utils.trackers.SealCommTracker`, charged the
    commit and each step's messages.
    tamper: optional hook `tamper(phase, step, pub) -> pub`, phase in
    {"commit", "round1", "round2"} (step None for the commit): what it
    returns lands on the board, as a malicious party would publish it.
    mesh: optional bidder mesh (`parallel.mesh.make_mesh`,
    `parallel.distributed.global_mesh`), called on every rank with the same
    arguments.  The bids are padded with zero bids (honest parties that
    cannot change the maximum) to a multiple of the mesh size, and the
    trackers count the padded n.  Every rank returns the same result, with
    the whole board, equal to the unsharded run's from the same generator.
    """
    bids = list(bids)
    if mesh is not None:
        bids += [0] * (M.pad_bidders(len(bids), mesh.size()) - len(bids))
    if generator is None:
        generator = M.new_generator(mesh)
    n = len(bids)
    rows = M.bidder_rows(mesh, n)
    bits = torch.as_tensor(bids_to_bits(bids, c), device=device)[rows]
    ids = torch.arange(n, device=device)[rows]
    if mesh is not None:
        generator = F.Rows(generator, rows, n)
    phase = phase_runner("seal", phase_times, bits.device, times)
    if times is not None or tamper is not None:
        return _run_metered(curve, generator, bits, ids, verify, phase,
                            trackers, tamper, mesh)

    ok = torch.ones((), dtype=torch.bool, device=bits.device)
    commit_pub, commit_sec = phase("commit", commit, curve, generator, bits, ids)
    if verify:
        ok = ok & phase("verify_commit",
                        lambda: verify_commit(curve, commit_pub, ids).all())
    pub1, sec1 = phase("round_one", round_one_batch, curve, generator,
                       bits.shape[0], c, ids)
    if verify:
        ok = ok & phase("verify_round_one",
                        lambda: verify_round_one_batch(curve, pub1, ids).all())
    Y_all = phase("avnet", avnet_rows, curve, pub1.X, mesh, 1)
    b01 = phase("b01", _b01, curve, Y_all, pub1.R, sec1.x)
    pre = Precomputed(pub1=pub1, sec1=sec1, Y=Y_all, b0=b01[0], b1=b01[1])
    deciding, ok_steps, round2 = phase("steps", run_steps, curve, generator,
                                       pre, bits, ids, commit_pub, commit_sec,
                                       verify, mesh)
    if trackers is not None:
        trackers.account_commit(n, c)
        stage2 = False
        for bit in deciding:
            trackers.account_step(n, stage2=stage2)
            stage2 = stage2 or bit
    if verify and not M.all_true(mesh, ok & ok_steps):
        return AuctionResult(max_bid=-1, verified=False,
                             deciding_bits=np.zeros(c, np.uint8))
    return AuctionResult(max_bid=bits_to_int(deciding), verified=True,
                         deciding_bits=np.asarray(deciding, np.uint8),
                         board=_gather_board(mesh, commit_pub, pub1, round2))
