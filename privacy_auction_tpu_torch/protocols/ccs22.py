"""CCS22 protocol: secure auction with a rational evaluator, in PyTorch.

Counterpart of the fused driver of `privacy_auction_tpu/protocols/ccs22.py`
(`run_auction`'s default path).  One party is the evaluator; each bit step
runs an anonymous-veto round whose result only the evaluator learns,
through a 2-message DDH oblivious transfer, and then announces:

  setup       per party: per-step keys x, r and OT randomness s, t;
              X = g^x published; H = SHA256(secrets) (the evaluator also
              hashes its OT betas); commitment Com = g^bid * g1^H * h^rcom
  per step:   BESEncode  B = x*Y (d = 0) | g^r (d = 1), d = in_race & bit
              OTReceive1 T2 = g^k, G = g^beta * g1^alpha, H = h^beta * T2^alpha
              OTSend     z = g^s * h^t, C0 = G^s * H^t + B,
                         C1 = (G/g1)^s * (H/T2)^t + M1 (a random point)
              OTReceive2 M0 = C0 - beta*z, summed with the evaluator's own B;
                         announce own d OR (sum != infinity)
              race       on an announced 1, a party stays in iff its d was 1

The fused driver hoists every ladder out of the steps, as the JAX package
does: the OT messages factor over the evaluator's choice bit alpha, so the
seven ladder passes over all (n, c) lanes run once (`_precompute`) and each
step is point adds and branchless selects (`_scan_steps`, a host loop).  The
announced bit drives only device-side bookkeeping, so the steps never read
it back; the run synchronizes once, at the end.

The role-metered driver (`run_auction(times=...)`, `_run_metered`) runs
each step as the JAX package's does, one call a phase: BES encoding and the
OT reply are bidder time, both OT receiver calls evaluator time.

Randomness: every scalar enters explicitly (`setup_from`, `ot_receive1_from`,
`ot_send_from`, `run_auction(draws=...)`), or is drawn from one
`torch.Generator` in a fixed order; a CPU generator gives the same scalars
on every device.  The evaluator's id is a value, never a branch that
changes shapes.  The protocol has no verification phase (the commitments
bind the parties for a later audit), so no proof is generated or checked.

Both drivers run on a bidder mesh (`run_auction(mesh=...)`,
`parallel/mesh.py`): each rank draws every scalar of all n lanes, in the
unsharded order, keeps its rows and runs the lane-local ladders on them.
It gathers where the protocol crosses bidders: the evaluator's commitment
hash (its own secrets and every lane's OT betas), the AV-net keys, the
evaluator's effective bit (its OT choice, which may live on any rank) and
the veto sum it announces, each over all n lanes on every rank, so every
rank announces the same bits.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..curves import Curve, make_comb_table
from ..ops import ec
from ..ops import field as F
from ..ops.sha256 import digest_to_scalar, sha256
from ..parallel import mesh as M
from .phases import phase_runner
from .seal import avnet_rows, bids_to_bits, bits_to_int

LIMBS = F.LIMBS


# --------------------------------------------------------------------------
# public parameters (CRS)
# --------------------------------------------------------------------------

class PubParams(NamedTuple):
    """CRS: two extra generators with their comb tables."""

    g1: torch.Tensor        # (3, L)
    h: torch.Tensor         # (3, L)
    g1_table: torch.Tensor  # (64, 16, 3, L)
    h_table: torch.Tensor


def make_pub_params(curve: Curve, device="cuda") -> PubParams:
    """g1 and h are hash-to-curve points (try-and-increment over SHA-256 on
    the host): nobody knows their discrete logs to g or to each other."""
    host = curve.host
    g1_h = host.hash_to_curve(b"ccs22-crs-g1")
    h_h = host.hash_to_curve(b"ccs22-crs-h")
    enc = ec.encode_host_points([g1_h, h_h], device)

    def table(P):
        return torch.as_tensor(make_comb_table(host, P)).to(device)

    return PubParams(g1=enc[0], h=enc[1], g1_table=table(g1_h),
                     h_table=table(h_h))


@functools.lru_cache(maxsize=None)
def _pp_cached(curve: Curve, device: torch.device) -> PubParams:
    return make_pub_params(curve, device)


def pp_or_make(curve: Curve, device="cuda") -> PubParams:
    """The CRS on `device`, made once per curve and device."""
    return _pp_cached(curve, torch.device(device))


# --------------------------------------------------------------------------
# setup
# --------------------------------------------------------------------------

class SetupSec(NamedTuple):
    x: torch.Tensor     # (n, c, L) per-step AV-net keys
    r: torch.Tensor     # (n, c, L) per-step veto randomness
    s: torch.Tensor     # (n, c, L) OT sender randomness
    t: torch.Tensor     # (n, c, L)
    rcom: torch.Tensor  # (n, L) commitment blinding


class SetupPub(NamedTuple):
    X: torch.Tensor     # (n, c, 3, L) per-step public keys
    com: torch.Tensor   # (n, 3, L) commitments


def _lane_ids(n: int, device, mesh=None):
    """The lane ids of this rank's n rows."""
    rows = M.bidder_rows(mesh, n * M.mesh_size(mesh))
    return torch.arange(rows.start, rows.stop, device=device)


def setup_from(curve: Curve, pp: PubParams, bids, sec: SetupSec, eval_id,
               eval_betas=None, mesh=None) -> SetupPub:
    """Setup for all n parties from given secrets.  bids (n, L) limbs;
    eval_betas (n, c, L): the evaluator's OT betas, hashed into its H (its
    own lane's betas are unused but hashed, so the message has one shape).
    On a mesh, every argument holds this rank's rows; the evaluator's
    message is gathered."""
    fn = curve.fn
    n, c = sec.x.shape[:2]
    dev = sec.x.device
    X = ec.mul_base(curve, sec.x)
    # H_i = SHA256(x_i || r_i || s_i || t_i), 32 big-endian bytes a scalar
    msg = torch.cat([F.to_bytes_be(v).reshape(n, c * 32)
                     for v in (sec.x, sec.r, sec.s, sec.t)], dim=-1)
    H = digest_to_scalar(fn, sha256(msg))                  # (n, L)
    if eval_betas is not None:
        eid = torch.as_tensor(eval_id, device=dev).reshape(1)
        msg_all, betas_all = M.gather_bidders(mesh, (msg, eval_betas))
        emsg = torch.cat([msg_all.index_select(0, eid)[0],
                          F.to_bytes_be(betas_all).reshape(-1)])
        He = digest_to_scalar(fn, sha256(emsg))
        H = F.select(_lane_ids(n, dev, mesh) == eid, He, H)
    com = ec.add(curve, ec.mul_base(curve, bids),
                 ec.add(curve, ec.mul_comb(curve, pp.g1_table, H),
                        ec.mul_comb(curve, pp.h_table, sec.rcom)))
    return SetupPub(X=X, com=com)


def draw_setup(curve: Curve, generator, n: int, c: int, device) -> SetupSec:
    """The setup secrets from `generator`: x, r, s, t, then rcom."""
    x, r, s, t = F.random(curve.fn, generator, (4, n, c), device)
    return SetupSec(x=x, r=r, s=s, t=t,
                    rcom=F.random(curve.fn, generator, (n,), device))


def setup(curve: Curve, generator, pp: PubParams, bids, c: int, eval_id,
          eval_betas=None):
    """Setup with secrets drawn from `generator`; returns (SetupPub,
    SetupSec)."""
    sec = draw_setup(curve, generator, bids.shape[0], c, bids.device)
    return setup_from(curve, pp, bids, sec, eval_id, eval_betas), sec


# --------------------------------------------------------------------------
# BES encode
# --------------------------------------------------------------------------

def bes_encode(curve: Curve, X_step, x_step, r_step, d, mesh=None):
    """AV-net bit encoding for all parties (this rank's on a mesh): X_step
    (n, 3, L) the step's public keys, d (n,) the effective bits; B = x*Y if
    d == 0 else g^r."""
    Y = avnet_rows(curve, X_step, mesh)
    enc0 = ec.scalar_mul(curve, Y, x_step)
    enc1 = ec.mul_base(curve, r_step)
    return ec.select(d == 0, enc0, enc1)


# --------------------------------------------------------------------------
# oblivious transfer (2-message DDH OT, per bidder lane)
# --------------------------------------------------------------------------

class OTR1(NamedTuple):
    """Receiver message, per bidder lane."""

    T2: torch.Tensor  # (n, 3, L) g^k
    G: torch.Tensor   # (n, 3, L) g^beta * g1^alpha
    H: torch.Tensor   # (n, 3, L) h^beta * T2^alpha


class OTS(NamedTuple):
    """Sender message, per bidder lane."""

    z: torch.Tensor   # (n, 3, L)
    C0: torch.Tensor  # (n, 3, L)
    C1: torch.Tensor  # (n, 3, L)


def ot_receive1_from(curve: Curve, pp: PubParams, beta, alpha, k) -> OTR1:
    """The evaluator's first OT message for all lanes.  beta, k (n, L);
    alpha: the evaluator's own effective bit, its choice.  T1 is fixed to
    g1.  X^alpha = select(alpha, X, infinity) is added in, branchless."""
    n = beta.shape[0]
    dev = beta.device
    T2 = ec.mul_base(curve, k)
    gb = ec.mul_base(curve, beta)
    hb = ec.mul_comb(curve, pp.h_table, beta)
    a = (torch.as_tensor(alpha, device=dev) != 0).expand(n)
    inf = ec.infinity(dev, (n,))
    G = ec.add(curve, gb, ec.select(a, pp.g1.expand(n, 3, LIMBS), inf))
    H = ec.add(curve, hb, ec.select(a, T2, inf))
    return OTR1(T2=T2, G=G, H=H)


def ot_receive1(curve: Curve, generator, pp: PubParams, beta, alpha) -> OTR1:
    k = F.random(curve.fn, generator, beta.shape[:1], beta.device)
    return ot_receive1_from(curve, pp, beta, alpha, k)


def ot_send_from(curve: Curve, pp: PubParams, r1: OTR1, B, s, t, m1k) -> OTS:
    """The bidders' OT reply, all lanes at once.  B (n, 3, L): the AV-net
    ciphertexts (message M0); s, t (n, L); M1 = g^m1k a random point."""
    M1 = ec.mul_base(curve, m1k)
    z = ec.add(curve, ec.mul_base(curve, s), ec.mul_comb(curve, pp.h_table, t))
    mask0 = ec.dual_mul(curve, r1.G, s, r1.H, t)
    C0 = ec.add(curve, mask0, B)
    Gm = ec.add(curve, r1.G, ec.neg(curve, pp.g1.expand(B.shape)))
    Hm = ec.add(curve, r1.H, ec.neg(curve, r1.T2))
    mask1 = ec.dual_mul(curve, Gm, s, Hm, t)
    C1 = ec.add(curve, mask1, M1)
    return OTS(z=z, C0=C0, C1=C1)


def ot_send(curve: Curve, generator, pp: PubParams, r1: OTR1, B, s, t) -> OTS:
    m1k = F.random(curve.fn, generator, B.shape[:-2], B.device)
    return ot_send_from(curve, pp, r1, B, s, t, m1k)


def _announce(curve: Curve, M0, own_B, d, eval_id, mesh=None):
    """The evaluator's lane carries no OT message: its own B stands there.
    Announce its own d OR (sum of the lanes != infinity).  M0 and own_B
    hold this rank's rows, d (the effective bits) every lane's.  The
    evaluator's lane is read with `index_select`, which needs no read back
    to the host (indexing by a tensor would)."""
    eid = torch.as_tensor(eval_id, device=M0.device).reshape(1)
    M0 = ec.select(_lane_ids(M0.shape[0], M0.device, mesh) == eid, own_B, M0)
    total = ec.ec_sum(curve, M.gather_bidders(mesh, M0), dim=0)
    return (d.index_select(0, eid)[0] != 0) | ~ec.is_infinity(total)


def ot_receive2(curve: Curve, ots: OTS, beta, own_B, d, eval_id, mesh=None):
    """The evaluator recovers the veto sum and announces the step bit; the
    decryption always runs.  d: every lane's effective bits.  Returns a ()
    bool tensor."""
    M0 = ec.add(curve, ots.C0, ec.neg(curve, ec.scalar_mul(curve, ots.z, beta)))
    return _announce(curve, M0, own_B, d, eval_id, mesh)


def update_race(in_race, d, announced):
    """On an announced 1, a party stays in the race iff its own effective
    bit was 1."""
    return torch.where(announced, in_race & d, in_race)


# --------------------------------------------------------------------------
# fused driver
# --------------------------------------------------------------------------

class Draws(NamedTuple):
    """Every scalar one fused auction draws, in the order it draws them."""

    beta: torch.Tensor    # (n, c, L) the evaluator's OT randomness
    sec: SetupSec
    k_rand: torch.Tensor  # (n, c, L) the evaluator's OT nonces
    m1k: torch.Tensor     # (n, c, L) the senders' dummy messages


def draw(curve: Curve, generator, n: int, c: int, device) -> Draws:
    beta = F.random(curve.fn, generator, (n, c), device)
    sec = draw_setup(curve, generator, n, c, device)
    k_rand, m1k = F.random(curve.fn, generator, (2, n, c), device)
    return Draws(beta=beta, sec=sec, k_rand=k_rand, m1k=m1k)


class Precomputed(NamedTuple):
    """The state-independent point streams of all c steps, step-major
    (c, n, 3, L)."""

    enc0: torch.Tensor  # Y^x
    enc1: torch.Tensor  # g^r
    T2: torch.Tensor    # g^k
    M1: torch.Tensor    # g^m1k
    gb: torch.Tensor    # g^beta
    hb: torch.Tensor    # h^beta
    z: torch.Tensor     # g^s h^t
    bz: torch.Tensor    # z^beta
    E: torch.Tensor     # g1^s T2^t
    m0a: torch.Tensor   # gb^s hb^t


def _precompute(curve: Curve, pp: PubParams, X, draws: Draws,
                mesh=None) -> Precomputed:
    """The seven hoisted ladder passes over all (n, c) lanes.  With alpha
    the evaluator's choice bit:  G = gb + alpha*g1,  H = hb + alpha*T2,
    G^s H^t = m0a + alpha*E,  (G/g1)^s (H/T2)^t = m0a + (alpha-1)*E,  and
    beta*z = z^beta."""
    sec, beta = draws.sec, draws.beta
    Y = avnet_rows(curve, X, mesh)                        # along the parties
    enc1, T2, M1, gb = ec.mul_base(
        curve, torch.stack([sec.r, draws.k_rand, draws.m1k, beta]))
    hb = ec.mul_comb(curve, pp.h_table, beta)
    z = ec.add(curve, ec.mul_base(curve, sec.s),
               ec.mul_comb(curve, pp.h_table, sec.t))
    enc0, bz = ec.scalar_mul(curve, torch.stack([Y, z]),
                             torch.stack([sec.x, beta]))
    E = ec.dual_mul(curve, pp.g1.expand(X.shape), sec.s, T2, sec.t)
    m0a = ec.dual_mul(curve, gb, sec.s, hb, sec.t)
    return Precomputed(*(a.transpose(0, 1) for a in
                         (enc0, enc1, T2, M1, gb, hb, z, bz, E, m0a)))


def _scan_steps(curve: Curve, pre: Precomputed, g1n, bits, eval_id,
                mesh=None):
    """The c steps over the precomputed streams, most significant bit
    first.  Returns (announced (c,) bool, OTR1 and OTS with leading axis c),
    all on the device: nothing is read back between steps (but the gathers
    of a mesh of gloo ranks, through the host)."""
    n, c = bits.shape
    dev = bits.device
    eid = torch.as_tensor(eval_id, device=dev).reshape(1)
    in_race = torch.ones((n,), dtype=F.DTYPE, device=dev)
    announced, r1s, otss = [], [], []
    for step in range(c):
        p = Precomputed(*(a[step] for a in pre))
        d = bits[:, step] & in_race
        B = ec.select(d == 0, p.enc0, p.enc1)
        d_all = M.gather_bidders(mesh, d)
        alpha = (d_all.index_select(0, eid) != 0).expand(n)
        # the receiver's message and both sender masks, each with and
        # without the alpha term, in one batched add
        up = ec.add(curve, torch.stack([p.gb, p.hb, p.m0a, p.m0a]),
                    torch.stack([g1n, p.T2, p.E, ec.neg(curve, p.E)]))
        G = ec.select(alpha, up[0], p.gb)
        H = ec.select(alpha, up[1], p.hb)
        mask0 = ec.select(alpha, up[2], p.m0a)
        mask1 = ec.select(alpha, p.m0a, up[3])
        C0, C1 = ec.add(curve, torch.stack([mask0, mask1]),
                        torch.stack([B, p.M1]))
        M0 = ec.add(curve, C0, ec.neg(curve, p.bz))
        ann = _announce(curve, M0, B, d_all, eid, mesh)
        in_race = update_race(in_race, d, ann)
        announced.append(ann)
        r1s.append(OTR1(T2=p.T2, G=G, H=H))
        otss.append(OTS(z=p.z, C0=C0, C1=C1))
    return (torch.stack(announced),
            OTR1(*(torch.stack(f) for f in zip(*r1s))),
            OTS(*(torch.stack(f) for f in zip(*otss))))


class Board(NamedTuple):
    """Every published message of one auction."""

    setup: SetupPub
    otr1: OTR1          # fields (c, n, 3, L)
    ots: OTS
    announced: torch.Tensor  # (c,) bool


class AuctionResult(NamedTuple):
    max_bid: int
    deciding_bits: np.ndarray  # (c,) uint8
    board: Board


def _run_metered(curve: Curve, pp: PubParams, pub: SetupPub, bits, eval_id,
                 draws: Draws, phase, mesh=None):
    """The c steps as one call a phase and role, as the JAX package's
    role-metered driver runs them: BES encoding and the OT reply are bidder
    time, both OT receiver calls evaluator time.  Fed the fused driver's
    draws, it announces the same bits.  Returns (announced (c,) bool, OTR1
    and OTS with leading axis c)."""
    from ..utils.trackers import CATEGORY_BIDDER, CATEGORY_EVALUATOR

    n, c = bits.shape
    sec, beta = draws.sec, draws.beta
    eid = torch.as_tensor(eval_id, device=bits.device).reshape(1)
    in_race = torch.ones((n,), dtype=F.DTYPE, device=bits.device)
    announced, r1s, otss = [], [], []
    for step in range(c):
        d = bits[:, step] & in_race
        d_all = M.gather_bidders(mesh, d)
        B = phase("bes_encode", bes_encode, curve, pub.X[:, step],
                  sec.x[:, step], sec.r[:, step], d, mesh,
                  role=CATEGORY_BIDDER)
        r1 = phase("ot_receive1", ot_receive1_from, curve, pp, beta[:, step],
                   d_all.index_select(0, eid), draws.k_rand[:, step],
                   role=CATEGORY_EVALUATOR)
        ots = phase("ot_send", ot_send_from, curve, pp, r1, B,
                    sec.s[:, step], sec.t[:, step], draws.m1k[:, step],
                    role=CATEGORY_BIDDER)
        ann = phase("ot_receive2", ot_receive2, curve, ots, beta[:, step], B,
                    d_all, eid, mesh, role=CATEGORY_EVALUATOR)
        in_race = update_race(in_race, d, ann)
        announced.append(ann)
        r1s.append(r1)
        otss.append(ots)
    return (torch.stack(announced),
            OTR1(*(torch.stack(f) for f in zip(*r1s))),
            OTS(*(torch.stack(f) for f in zip(*otss))))


def run_auction(curve: Curve, bids, c: int, eval_id: int = 0,
                generator: torch.Generator | None = None, device="cuda",
                phase_times: dict | None = None,
                draws: Draws | None = None, times=None,
                trackers=None, mesh=None) -> AuctionResult:
    """Full CCS22 auction for integer bids, the evaluator at lane eval_id
    (also a bidder).

    The fused driver (the default) runs the setup, the hoisted ladder
    passes, then the c steps, with one synchronization at the end.  With
    `times` the steps run as one call a phase and role (`_run_metered`)
    from the same draws; the board holds the same messages (OT messages
    that the fused driver assembles from its hoisted passes agree as
    points, not as projective limbs).

    generator: the source of every scalar when `draws` is not given (a
    fresh, OS-seeded CPU generator when None, on a mesh seeded from rank
    0; not a cryptographic generator).  phase_times: optional dict; each
    phase's wall time in seconds, taken after a device synchronize, is
    added under its name.  Each phase runs in a `torch.profiler` range
    named `ccs22.<phase>`.  times: optional `utils.trackers.TimeTracker`:
    the setup, BES encoding and the OT reply accrue to "bidder", both OT
    receiver calls to "evaluator"; then 1/n of the bidder time moves to
    the evaluator, whose own bidder lane the batched calls carry (on a
    mesh: this rank's times, moved on the evaluator's rank).  trackers:
    optional `utils.trackers.Ccs22CommTracker`, charged each step's
    messages (the caller charges the setup, as the CLI does).
    mesh: optional bidder mesh (`parallel.mesh`), called on every rank
    with the same arguments: the bids are padded with zero bids to a
    multiple of the mesh size (`draws`, if given, are the padded n's), and
    every rank returns the same result, with the whole board, equal to the
    unsharded run's from the same draws.
    """
    from ..utils.trackers import CATEGORY_BIDDER, CATEGORY_EVALUATOR

    bids = list(bids)
    if mesh is not None:
        bids += [0] * (M.pad_bidders(len(bids), mesh.size()) - len(bids))
    n = len(bids)
    rows = M.bidder_rows(mesh, n)
    bits = torch.as_tensor(bids_to_bits(bids, c), device=device)[rows]
    bid_scalars = torch.as_tensor(
        F.ints_to_limbs([b % curve.host.n for b in bids])).to(device)[rows]
    if draws is None:
        if generator is None:
            generator = M.new_generator(mesh)
        draws = draw(curve, generator, n, c, device)
    if draws.beta.shape[0] != n:
        raise ValueError(f"draws for {draws.beta.shape[0]} lanes, the auction "
                         f"has {n}")
    draws = M.shard_bidders(mesh, draws)
    pp = pp_or_make(curve, device)

    phase = phase_runner("ccs22", phase_times, bits.device, times)
    bidder_t0 = (times.get_category_time_seconds(CATEGORY_BIDDER)
                 if times is not None else 0.0)
    pub = phase("setup", setup_from, curve, pp, bid_scalars, draws.sec,
                eval_id, draws.beta, mesh, role=CATEGORY_BIDDER)
    if times is None:
        pre = phase("precompute", _precompute, curve, pp, pub.X, draws, mesh)
        announced, r1, ots = phase("steps", _scan_steps, curve, pre,
                                   pp.g1.expand(bits.shape[0], 3, LIMBS), bits,
                                   eval_id, mesh)
    else:
        announced, r1, ots = _run_metered(curve, pp, pub, bits, eval_id,
                                          draws, phase, mesh)
        if n > 1 and rows.start <= eval_id < rows.stop:
            # the batched bidder calls carry the evaluator's own bidder
            # lane; the reference's bidder loops leave the evaluator out
            # (`CCS22/main.cpp:95,111`), so 1/n of that time is its
            shift = (times.get_category_time_seconds(CATEGORY_BIDDER)
                     - bidder_t0) / bits.shape[0]
            times.add_time(CATEGORY_BIDDER, -shift)
            times.add_time(CATEGORY_EVALUATOR, shift)
    deciding = announced.cpu().numpy().astype(np.uint8)
    if trackers is not None:
        for _ in range(c):
            trackers.account_step(n)
    pub = M.gather_bidders(mesh, pub)
    r1, ots = M.gather_bidders(mesh, (r1, ots), 1)   # (c, n, ...)
    return AuctionResult(max_bid=bits_to_int(deciding),
                         deciding_bits=deciding,
                         board=Board(setup=pub, otr1=r1, ots=ots,
                                     announced=announced))
