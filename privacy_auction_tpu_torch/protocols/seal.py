"""SEAL protocol: sealed-bid first-price auction without auctioneers, in
PyTorch.

Counterpart of the fused driver of `privacy_auction_tpu/protocols/seal.py`
(`run_auction`'s default path): commit, commit verification, the hoisted
state-independent passes for all c steps (round-1 keygens and their
PoKDLog checks, AV-net keys, both ciphertext candidates), then the c
auction steps.  Each step generates and verifies a Stage1 or Stage2 proof
(one ladder pass each) and runs the round-3 veto sum.

The steps are a host loop.  Stage selection branches on the public
junction flag, read with one `.item()` per step; the per-bidder work stays
branchless.  Every phase is one batched computation over all n bidders
(and all c bits or steps where the phase allows).

Randomness comes from one `torch.Generator`, drawn in a fixed order; a
CPU generator gives the same nonces on every device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import nizk
from ..curves import Curve
from ..ops import ec
from ..ops import field as F
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
    X: torch.Tensor  # (c, n, 3, L) g^x
    R: torch.Tensor  # (c, n, 3, L) g^r
    pok_x: nizk.PoKDLog
    pok_r: nizk.PoKDLog


class RoundOneSec(NamedTuple):
    x: torch.Tensor  # (c, n, L)
    r: torch.Tensor  # (c, n, L)


class StepInfo(NamedTuple):
    """One deciding step's state, the previous-step context of Stage2."""

    X: torch.Tensor   # (n, 3, L)
    R: torch.Tensor   # (n, 3, L)
    Y: torch.Tensor   # (n, 3, L)
    b: torch.Tensor   # (n, 3, L)
    x: torch.Tensor   # (n, L)   secret key (prover side only)
    d: torch.Tensor   # (n,)     effective encoded bit


class AuctionResult(NamedTuple):
    max_bid: int
    verified: bool
    deciding_bits: np.ndarray  # (c,) uint8


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


def round_one_batch(curve: Curve, generator, n: int, c: int, ids):
    """Round-1 keys X = g^x, R = g^r and their PoKDLogs for all c steps in
    one pass (they do not depend on the auction state).  Leading axes
    (c, n)."""
    fn = curve.fn
    dev = ids.device
    xr = F.random(fn, generator, (2, c, n), dev)
    v = F.random(fn, generator, (2, c, n), dev)
    pts4 = ec.mul_base(curve, torch.cat([xr, v], dim=0))
    pts, eps = pts4[:2], pts4[2:]
    steps = torch.arange(c, device=dev)[None, :, None].expand(2, c, n)
    pok_x, pok_r = _split(nizk.gen_pokdlog_from(
        curve, v, eps, pts, xr, ids.expand(2, c, n), steps))
    return (RoundOnePub(X=pts[0], R=pts[1], pok_x=pok_x, pok_r=pok_r),
            RoundOneSec(x=xr[0], r=xr[1]))


def verify_round_one_batch(curve: Curve, pub: RoundOnePub, ids):
    """All c steps' round-1 proofs verified in one pass -> (c, n) bool."""
    c, n = pub.X.shape[:2]
    steps = torch.arange(c, device=ids.device)[None, :, None].expand(2, c, n)
    ok = nizk.ver_pokdlog(
        curve,
        nizk.PoKDLog(torch.stack([pub.pok_x.eps, pub.pok_r.eps]),
                     torch.stack([pub.pok_x.rho, pub.pok_r.rho])),
        torch.stack([pub.X, pub.R]), ids.expand(2, c, n), steps)
    return ok[0] & ok[1]


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


def _b01(curve: Curve, Y_all, R_all, x_all):
    """Both ciphertext candidates Y^x / R^x for every step: (2, c, n, 3, L)."""
    c, n = x_all.shape[:2]
    return ec.scalar_mul(curve, torch.stack([Y_all, R_all]),
                         x_all.expand(2, c, n, LIMBS))


def round_three(curve: Curve, b):
    """Veto aggregation: True iff sum_j b_j != infinity, i.e. the max-bid
    bit at this step is 1.  Returns a () bool tensor."""
    return ~ec.is_infinity(ec.ec_sum(curve, b, dim=0))


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------

class Precomputed(NamedTuple):
    """The state-independent streams of all c steps."""

    X: torch.Tensor     # (c, n, 3, L)
    R: torch.Tensor
    x: torch.Tensor     # (c, n, L)
    Y: torch.Tensor     # (c, n, 3, L)
    b0: torch.Tensor    # (c, n, 3, L) Y^x
    b1: torch.Tensor    # (c, n, 3, L) R^x


def run_steps(curve: Curve, generator, pre: Precomputed, bits, ids,
              commit_pub: CommitmentPub, commit_sec: CommitmentSec,
              verify: bool):
    """The c auction steps, most significant bit first.  Returns
    (deciding (c,) list of bool, ok () bool tensor)."""
    n, c = bits.shape
    dev = bits.device
    in_race = torch.ones((n,), dtype=F.DTYPE, device=dev)
    junction = False
    prev = None
    ok = torch.ones((), dtype=torch.bool, device=dev)
    deciding = []
    for s in range(c):
        d = bits[:, s] & in_race
        b = ec.select(d == 0, pre.b0[s], pre.b1[s])
        X, R, Y, x = pre.X[s], pre.R[s], pre.Y[s], pre.x[s]
        phi, A, B = commit_pub.phi[:, s], commit_pub.A[:, s], commit_pub.B[:, s]
        alpha = commit_sec.alpha[:, s]
        if not junction:
            proof = nizk.gen_powfstage1(curve, generator, X, Y, R, phi, A, B,
                                        x, alpha, d, ids, s, b)
            if verify:
                ok = ok & nizk.ver_powfstage1(curve, proof, b, X, Y, R, phi,
                                              A, B, ids, s).all()
        else:
            pts = dict(Xi=X, Ri=R, Yi=Y, Bj=prev.b, Xj=prev.X, Rj=prev.R,
                       Yj=prev.Y, Ci=phi, A=A, B=B)
            proof = nizk.gen_powfstage2(curve, generator, pts, x, prev.x,
                                        alpha, d, prev.d, ids, s, b)
            if verify:
                ok = ok & nizk.ver_powfstage2(curve, proof, dict(pts, Bi=b),
                                              ids, s).all()
        step_deciding = bool(round_three(curve, b).item())
        deciding.append(step_deciding)
        if step_deciding:
            prev = StepInfo(X=X, R=R, Y=Y, b=b, x=x, d=d)
            in_race = in_race & d
            junction = True
    return deciding, ok


def run_auction(curve: Curve, bids, c: int, verify: bool = True,
                generator: torch.Generator | None = None,
                device="cuda", times: dict | None = None) -> AuctionResult:
    """Full SEAL auction for integer bids: commit -> verify -> hoisted
    passes -> c steps.  A failed verification gives verified=False and
    max_bid=-1, as in the JAX package.

    generator: the source of every nonce (a fresh, OS-seeded CPU generator
    when None).  Like the JAX package's PRNG keys, it is not a
    cryptographic generator.
    times: optional dict; each phase's wall time in seconds, taken after a
    device synchronize, is stored under the phase's name.
    Each phase runs in a `torch.profiler` range named `seal.<phase>`.
    """
    if generator is None:
        generator = torch.Generator()
        generator.seed()
    n = len(bids)
    bits = torch.as_tensor(bids_to_bits(bids, c), device=device)
    ids = torch.arange(n, device=device)

    phase = phase_runner("seal", times, bits.device)
    ok = torch.ones((), dtype=torch.bool, device=bits.device)
    commit_pub, commit_sec = phase("commit", commit, curve, generator, bits, ids)
    if verify:
        ok = ok & phase("verify_commit",
                        lambda: verify_commit(curve, commit_pub, ids).all())
    pub1, sec1 = phase("round_one", round_one_batch, curve, generator, n, c, ids)
    if verify:
        ok = ok & phase("verify_round_one",
                        lambda: verify_round_one_batch(curve, pub1, ids).all())
    Y_all = phase("avnet", avnet_keys_steps, curve, pub1.X)
    b01 = phase("b01", _b01, curve, Y_all, pub1.R, sec1.x)
    pre = Precomputed(X=pub1.X, R=pub1.R, x=sec1.x, Y=Y_all, b0=b01[0],
                      b1=b01[1])
    deciding, ok_steps = phase("steps", run_steps, curve, generator, pre, bits,
                               ids, commit_pub, commit_sec, verify)
    if verify and not bool((ok & ok_steps).item()):
        return AuctionResult(max_bid=-1, verified=False,
                             deciding_bits=np.zeros(c, np.uint8))
    max_bid = 0
    for bit in deciding:
        max_bid = (max_bid << 1) | int(bit)
    return AuctionResult(max_bid=max_bid, verified=True,
                         deciding_bits=np.asarray(deciding, np.uint8))
