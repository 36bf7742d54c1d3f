"""Batched NIZK proof systems of the SEAL auction, in PyTorch.

Counterpart of `privacy_auction_tpu/nizk.py`: PoKDLog (Schnorr), PoWFCom
(2-branch OR proof over a bit commitment), PoWFStage1 (2 branches x 4
equations) and PoWFStage2 (3 branches x 16 equations).  Every equation has
the shape eps = base1^s * base2^t, so generation and verification are the
same batched computation: all equations of a proof system ride one
`ec.dual_mul` pass (`_eval_eqs`), and OR-proof branch selection is a
branchless scalar select before the EC work.

Fiat-Shamir transcripts are byte for byte those of the JAX package: the
domain tag, the 65-byte uncompressed generator, the 65-byte uncompressed
points in proof order, the prover id as 8 little-endian bytes, then the
step as 4 little-endian bytes.

Randomness: each generator has a `_from` form that takes its nonce scalars
explicitly; the form that takes a `torch.Generator` draws them with
`field.random` and calls it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .curves import Curve
from .ops import ec
from .ops import field as F
from .ops.sha256 import digest_to_scalar, sha256

TAG_POKDLOG = b"PA/PoKDLog\x00"
TAG_POWFCOM = b"PA/PoWFCom\x00"
TAG_STAGE1 = b"PA/PoWFStage1\x00"
TAG_STAGE2 = b"PA/PoWFStage2\x00"


# --------------------------------------------------------------------------
# Fiat-Shamir transcript hashing
# --------------------------------------------------------------------------

def _le_bytes(v, nbytes: int):
    """Integers (...,) -> (..., nbytes) uint8 little-endian (low 32 bits;
    bytes above the fourth are zero)."""
    v = v.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(0, 8 * min(nbytes, 4), 8, device=v.device)
    lo = (v.unsqueeze(-1) >> shifts) & 0xFF
    if nbytes > 4:
        lo = torch.nn.functional.pad(lo, (0, nbytes - 4))
    return lo.to(torch.uint8)


def _generator_octets(curve: Curve) -> np.ndarray:
    gx, gy = curve.host.g
    return np.array(list(b"\x04" + gx.to_bytes(32, "big") + gy.to_bytes(32, "big")),
                    np.uint8)


def fs_challenge(curve: Curve, points, ids, domain: bytes = b"", steps=None):
    """Fiat-Shamir challenge scalar from an ordered point list + prover id.

    points: sequence of (..., 3, L) projective points (broadcast-compatible
    batches); ids: (...,) integer tensor; steps: optional integer tensor
    bound as 4 LE bytes after the id.  All points are affinized in one
    batched inversion.  Returns (..., L) scalars mod n.
    """
    shape = torch.broadcast_shapes(*[p.shape for p in points])
    stacked = torch.stack([p.expand(shape) for p in points], dim=-3)
    octets = ec.serialize_uncompressed(curve, stacked)          # (..., N, 65)
    batch = octets.shape[:-2]
    dev = octets.device
    parts = []
    if domain:
        tag = torch.tensor(list(domain), dtype=torch.uint8, device=dev)
        parts.append(tag.expand(batch + tag.shape))
    g = torch.as_tensor(_generator_octets(curve), device=dev)
    parts += [g.expand(batch + g.shape),
              octets.reshape(batch + (octets.shape[-2] * 65,)),
              _le_bytes(torch.as_tensor(ids, device=dev), 8).expand(batch + (8,))]
    if steps is not None:
        parts.append(_le_bytes(torch.as_tensor(steps, device=dev), 4)
                     .expand(batch + (4,)))
    return digest_to_scalar(curve.fn, sha256(torch.cat(parts, dim=-1)))


def _g_minus(curve: Curve, P):
    """P / g (the reference's phi/g, c/g, Ci/g pattern)."""
    return ec.add(curve, P, ec.neg(curve, ec.generator(curve, P.device,
                                                       P.shape[:-2])))


def _sel(cond, a, b):
    """Scalar-limb select on condition (...,)."""
    return torch.where(cond.unsqueeze(-1), a, b)


# --------------------------------------------------------------------------
# equation evaluation: the shared core of gen and verify
# --------------------------------------------------------------------------

def _eval_eqs(curve: Curve, eqs):
    """Evaluate k equations base1^s * base2^t in one batched dual_mul pass.
    eqs: list of (base1, s, base2, t); base1=None means the generator g.
    Returns the stacked (k, ..., 3, L) result."""
    batch = torch.broadcast_shapes(*[e[2].shape[:-2] for e in eqs],
                                   *[e[1].shape[:-1] for e in eqs])
    dev = eqs[0][1].device
    P1, S, P2, T = [], [], [], []
    for b1, s, b2, t in eqs:
        if b1 is None:
            b1 = ec.generator(curve, dev, batch)
        P1.append(b1.expand(batch + (3, F.LIMBS)))
        S.append(s.expand(batch + (F.LIMBS,)))
        P2.append(b2.expand(batch + (3, F.LIMBS)))
        T.append(t.expand(batch + (F.LIMBS,)))
    return ec.dual_mul(curve, torch.stack(P1), torch.stack(S),
                       torch.stack(P2), torch.stack(T))


def _eq_all(curve: Curve, got, eps):
    """AND over all k computed equations against the published eps."""
    return ec.eq(curve, got, torch.stack(eps)).all(dim=0)


# --------------------------------------------------------------------------
# PoKDLog (Schnorr)
# --------------------------------------------------------------------------

class PoKDLog(NamedTuple):
    eps: torch.Tensor  # (..., 3, L) commitment g^v
    rho: torch.Tensor  # (..., L) response v - ch*x


def gen_pokdlog_from(curve: Curve, v, eps, X, x, ids, steps=None) -> PoKDLog:
    """Finish a Schnorr proof from nonce v and its commitment eps = g^v."""
    fn = curve.fn
    ch = fs_challenge(curve, [eps, X], ids, TAG_POKDLOG, steps)
    return PoKDLog(eps=eps, rho=F.sub(fn, v, F.mul(fn, ch, x)))


def gen_pokdlog(curve: Curve, generator, X, x, ids, steps=None) -> PoKDLog:
    """Prove knowledge of x with X = g^x, batched over x (..., L)."""
    v = F.random(curve.fn, generator, x.shape[:-1], x.device)
    return gen_pokdlog_from(curve, v, ec.mul_base(curve, v), X, x, ids, steps)


def ver_pokdlog(curve: Curve, proof: PoKDLog, X, ids, steps=None):
    """Check g^rho * X^ch == eps -> bool (...,)."""
    ch = fs_challenge(curve, [proof.eps, X], ids, TAG_POKDLOG, steps)
    lhs = ec.base_mul_add(curve, proof.rho, X, ch)
    return ec.eq(curve, lhs, proof.eps)


# --------------------------------------------------------------------------
# PoWFCom: 2-branch OR proof over the commitment triple
# --------------------------------------------------------------------------

class PoWFCom(NamedTuple):
    eps11: torch.Tensor
    eps12: torch.Tensor
    eps21: torch.Tensor
    eps22: torch.Tensor
    rho1: torch.Tensor
    rho2: torch.Tensor
    ch2: torch.Tensor


POWFCOM_NONCES = 3    # r1, rho_sim, ch_sim


def _powfcom_eqs(curve, phi, A, B, s1, t1, s2, t2):
    """eps11 = g^s1 A^t1; eps12 = B^s1 phi^t1; eps21 = g^s2 A^t2;
    eps22 = B^s2 (phi/g)^t2, in one ladder pass."""
    return _eval_eqs(curve, [
        (None, s1, A, t1),
        (B, s1, phi, t1),
        (None, s2, A, t2),
        (B, s2, _g_minus(curve, phi), t2),
    ])


def gen_powfcom_from(curve: Curve, r, phi, A, B, alpha, bit, ids,
                     steps=None) -> PoWFCom:
    """PoWFCom from nonces r (3, ..., L) = (r1, rho_sim, ch_sim), branchless
    over bit: the real branch gets (r1, t=0), the simulated one
    (rho_sim, ch_sim)."""
    fn = curve.fn
    r1, rho_sim, ch_sim = r[0], r[1], r[2]
    bit0 = bit == 0
    zero = torch.zeros_like(r1)
    s1 = _sel(bit0, r1, rho_sim)
    t1 = _sel(bit0, zero, ch_sim)
    s2 = _sel(bit0, rho_sim, r1)
    t2 = _sel(bit0, ch_sim, zero)
    e11, e12, e21, e22 = _powfcom_eqs(curve, phi, A, B, s1, t1, s2, t2).unbind(0)
    ch = fs_challenge(curve, [e11, e12, e21, e22, phi, A, B], ids,
                      TAG_POWFCOM, steps)
    ch_real = F.sub(fn, ch, ch_sim)
    rho_real = F.sub(fn, r1, F.mul(fn, alpha, ch_real))
    return PoWFCom(
        eps11=e11, eps12=e12, eps21=e21, eps22=e22,
        rho1=_sel(bit0, rho_real, rho_sim),
        rho2=_sel(bit0, rho_sim, rho_real),
        ch2=_sel(bit0, ch_sim, ch_real),
    )


def gen_powfcom(curve: Curve, generator, phi, A, B, alpha, bit, ids,
                steps=None) -> PoWFCom:
    r = F.random(curve.fn, generator, (POWFCOM_NONCES,) + alpha.shape[:-1],
                 alpha.device)
    return gen_powfcom_from(curve, r, phi, A, B, alpha, bit, ids, steps)


def ver_powfcom(curve: Curve, proof: PoWFCom, phi, A, B, ids, steps=None):
    """Verify the four equations -> bool (...,)."""
    fn = curve.fn
    ch = fs_challenge(curve, [proof.eps11, proof.eps12, proof.eps21,
                              proof.eps22, phi, A, B], ids, TAG_POWFCOM, steps)
    ch1 = F.sub(fn, ch, proof.ch2)
    got = _powfcom_eqs(curve, phi, A, B, proof.rho1, ch1, proof.rho2, proof.ch2)
    return _eq_all(curve, got, [proof.eps11, proof.eps12, proof.eps21,
                                proof.eps22])


def ver_commit_phase(curve: Curve, pok_a, pok_b, powf, phi, A, B, ids,
                     steps=None):
    """Both PoKDLogs and the PoWFCom checked with one dual-mul pass and one
    batched equality -> bool (...,)."""
    fn = curve.fn
    eps_ab = torch.stack([pok_a.eps, pok_b.eps])
    x_ab = torch.stack([A, B])
    ids2 = ids.expand((2,) + ids.shape)
    steps2 = None if steps is None else steps.expand((2,) + steps.shape)
    ch_ab = fs_challenge(curve, [eps_ab, x_ab], ids2, TAG_POKDLOG, steps2)
    ch = fs_challenge(curve, [powf.eps11, powf.eps12, powf.eps21, powf.eps22,
                              phi, A, B], ids, TAG_POWFCOM, steps)
    ch1 = F.sub(fn, ch, powf.ch2)
    got = _eval_eqs(curve, [
        (None, pok_a.rho, A, ch_ab[0]),
        (None, pok_b.rho, B, ch_ab[1]),
        (None, powf.rho1, A, ch1),
        (B, powf.rho1, phi, ch1),
        (None, powf.rho2, A, powf.ch2),
        (B, powf.rho2, _g_minus(curve, phi), powf.ch2),
    ])
    return _eq_all(curve, got, [pok_a.eps, pok_b.eps, powf.eps11, powf.eps12,
                                powf.eps21, powf.eps22])


# --------------------------------------------------------------------------
# PoWFStage1: 2-branch OR proof x 4 equations (pre-junction round 2)
# --------------------------------------------------------------------------

class PoWFStage1(NamedTuple):
    eps11: torch.Tensor
    eps12: torch.Tensor
    eps13: torch.Tensor
    eps14: torch.Tensor
    eps21: torch.Tensor
    eps22: torch.Tensor
    eps23: torch.Tensor
    eps24: torch.Tensor
    rho11: torch.Tensor
    rho12: torch.Tensor
    rho21: torch.Tensor
    rho22: torch.Tensor
    ch2: torch.Tensor


STAGE1_NONCES = 5     # r11, r12, rho_s1, rho_s2, ch_sim


def _stage1_eqs(curve, b, X, Y, R, c, A, B, s11, s12, t1, s21, s22, t2):
    """The eight Stage1 equations in one ladder pass:
    eps11 = g^s11 X^t1   eps12 = g^s12 A^t1
    eps13 = Y^s11 b^t1   eps14 = B^s12 c^t1
    eps21 = g^s21 X^t2   eps22 = g^s22 A^t2
    eps23 = R^s21 b^t2   eps24 = B^s22 (c/g)^t2
    """
    return _eval_eqs(curve, [
        (None, s11, X, t1),
        (None, s12, A, t1),
        (Y, s11, b, t1),
        (B, s12, c, t1),
        (None, s21, X, t2),
        (None, s22, A, t2),
        (R, s21, b, t2),
        (B, s22, _g_minus(curve, c), t2),
    ])


def gen_powfstage1_from(curve: Curve, r, X, Y, R, c, A, B, x, alpha, bit,
                        ids, steps, b) -> PoWFStage1:
    """Stage1 from nonces r (5, ..., L), branchless over bit; b is the
    round-2 ciphertext Y^x (bit 0) | R^x (bit 1)."""
    fn = curve.fn
    r11, r12, rho_s1, rho_s2, ch_sim = r.unbind(0)
    bit0 = bit == 0
    zero = torch.zeros_like(r11)
    s11 = _sel(bit0, r11, rho_s1)
    s12 = _sel(bit0, r12, rho_s2)
    t1 = _sel(bit0, zero, ch_sim)
    s21 = _sel(bit0, rho_s1, r11)
    s22 = _sel(bit0, rho_s2, r12)
    t2 = _sel(bit0, ch_sim, zero)
    eqs = tuple(_stage1_eqs(curve, b, X, Y, R, c, A, B, s11, s12, t1, s21,
                            s22, t2).unbind(0))
    ch = fs_challenge(curve, list(eqs) + [b, X, Y, R, c, A, B], ids,
                      TAG_STAGE1, steps)
    ch_real = F.sub(fn, ch, ch_sim)
    rho_x = F.sub(fn, r11, F.mul(fn, x, ch_real))
    rho_a = F.sub(fn, r12, F.mul(fn, alpha, ch_real))
    return PoWFStage1(
        *eqs,
        rho11=_sel(bit0, rho_x, rho_s1),
        rho12=_sel(bit0, rho_a, rho_s2),
        rho21=_sel(bit0, rho_s1, rho_x),
        rho22=_sel(bit0, rho_s2, rho_a),
        ch2=_sel(bit0, ch_sim, ch_real),
    )


def gen_powfstage1(curve: Curve, generator, X, Y, R, c, A, B, x, alpha, bit,
                   ids, steps, b) -> PoWFStage1:
    r = F.random(curve.fn, generator, (STAGE1_NONCES,) + x.shape[:-1], x.device)
    return gen_powfstage1_from(curve, r, X, Y, R, c, A, B, x, alpha, bit, ids,
                               steps, b)


def ver_powfstage1(curve: Curve, proof: PoWFStage1, b, X, Y, R, c, A, B, ids,
                   steps=None):
    """Verify the eight equations -> bool (...,)."""
    fn = curve.fn
    eps = list(proof[:8])
    ch = fs_challenge(curve, eps + [b, X, Y, R, c, A, B], ids, TAG_STAGE1,
                      steps)
    ch1 = F.sub(fn, ch, proof.ch2)
    got = _stage1_eqs(curve, b, X, Y, R, c, A, B, proof.rho11, proof.rho12,
                      ch1, proof.rho21, proof.rho22, proof.ch2)
    return _eq_all(curve, got, eps)


# --------------------------------------------------------------------------
# PoWFStage2: 3-branch OR proof x 16 equations (post-junction round 2)
# --------------------------------------------------------------------------

class PoWFStage2(NamedTuple):
    """Branch 1: bi=1 (=> bj=1); branch 2: bi=0, bj=1; branch 3: bi=bj=0."""

    eps11: torch.Tensor
    eps12: torch.Tensor
    eps13: torch.Tensor
    eps11p: torch.Tensor
    eps12p: torch.Tensor
    eps13p: torch.Tensor
    eps21: torch.Tensor
    eps22: torch.Tensor
    eps23: torch.Tensor
    eps21p: torch.Tensor
    eps22p: torch.Tensor
    eps23p: torch.Tensor
    eps31: torch.Tensor
    eps32: torch.Tensor
    eps31p: torch.Tensor
    eps32p: torch.Tensor
    rho11: torch.Tensor
    rho12: torch.Tensor
    rho13: torch.Tensor
    rho21: torch.Tensor
    rho22: torch.Tensor
    rho23: torch.Tensor
    rho31: torch.Tensor
    rho32: torch.Tensor
    ch2: torch.Tensor
    ch3: torch.Tensor


STAGE2_NONCES = 14    # r1..r3, 8 simulated responses, 3 simulated challenges


def _stage2_eqs(curve, pts, s):
    """The sixteen Stage2 equations in one ladder pass (PoWFStage2 field
    order); pts: public points including the ciphertext 'Bi'; s: branch
    scalars s{m}{l} and challenges t{m}."""
    Xi, Xj, A = pts["Xi"], pts["Xj"], pts["A"]
    Bi, Bj, B = pts["Bi"], pts["Bj"], pts["B"]
    Ri, Rj, Ci = pts["Ri"], pts["Rj"], pts["Ci"]
    Yi, Yj = pts["Yi"], pts["Yj"]
    return _eval_eqs(curve, [
        (None, s["s11"], Xi, s["t1"]),
        (None, s["s12"], Xj, s["t1"]),
        (None, s["s13"], A, s["t1"]),
        (Ri, s["s11"], Bi, s["t1"]),
        (Rj, s["s12"], Bj, s["t1"]),
        (B, s["s13"], _g_minus(curve, Ci), s["t1"]),
        (None, s["s21"], Xi, s["t2"]),
        (None, s["s22"], Xj, s["t2"]),
        (None, s["s23"], A, s["t2"]),
        (Yi, s["s21"], Bi, s["t2"]),
        (Rj, s["s22"], Bj, s["t2"]),
        (B, s["s23"], Ci, s["t2"]),
        (None, s["s31"], Xi, s["t3"]),
        (None, s["s32"], Xj, s["t3"]),
        (Yi, s["s31"], Bi, s["t3"]),
        (Yj, s["s32"], Bj, s["t3"]),
    ])


STAGE2_FS_PTS = ("Xi", "Xj", "A", "Bi", "Bj", "B", "Ri", "Rj", "Ci", "Yi", "Yj")


def gen_powfstage2_from(curve: Curve, r, pts, xi, xj, alphai, bi, bj, ids,
                        steps, b) -> PoWFStage2:
    """Stage2 from nonces r (14, ..., L), branchless over (bi, bj).  Real
    branch: 1 if bi==1, 2 if bi==0 and bj==1, 3 if bi==bj==0; every
    simulated response is uniformly random.  b is the ciphertext Bi; pts
    must not contain "Bi"."""
    fn = curve.fn
    r1, r2, r3 = r[0], r[1], r[2]
    sim = {
        (1, 1): r[3], (1, 2): r[4], (1, 3): r[5],
        (2, 1): r[6], (2, 2): r[7], (2, 3): r[8],
        (3, 1): r[9], (3, 2): r[10],
    }
    ch_sim = {1: r[11], 2: r[12], 3: r[13]}
    is_real = {1: bi == 1, 2: (bi == 0) & (bj == 1), 3: (bi == 0) & (bj == 0)}
    rr = {1: r1, 2: r2, 3: r3}
    zero = torch.zeros_like(r1)
    scal = {}
    for m in (1, 2, 3):
        for l in ((1, 2, 3) if m != 3 else (1, 2)):
            scal[f"s{m}{l}"] = _sel(is_real[m], rr[l], sim[(m, l)])
        scal[f"t{m}"] = _sel(is_real[m], zero, ch_sim[m])

    pts = dict(pts, Bi=b)
    eqs = tuple(_stage2_eqs(curve, pts, scal).unbind(0))
    ch = fs_challenge(curve, list(eqs) + [pts[k] for k in STAGE2_FS_PTS], ids,
                      TAG_STAGE2, steps)
    sim_sum = torch.zeros_like(ch)
    for m in (1, 2, 3):
        sim_sum = F.add(fn, sim_sum, _sel(is_real[m], zero, ch_sim[m]))
    ch_real = F.sub(fn, ch, sim_sum)
    secrets = {1: xi, 2: xj, 3: alphai}
    rho_real = {l: F.sub(fn, rr[l], F.mul(fn, secrets[l], ch_real))
                for l in (1, 2, 3)}
    out = {}
    for m in (1, 2, 3):
        for l in ((1, 2, 3) if m != 3 else (1, 2)):
            out[f"rho{m}{l}"] = _sel(is_real[m], rho_real[l], sim[(m, l)])
    return PoWFStage2(
        *eqs, **out,
        ch2=_sel(is_real[2], ch_real, ch_sim[2]),
        ch3=_sel(is_real[3], ch_real, ch_sim[3]),
    )


def gen_powfstage2(curve: Curve, generator, pts, xi, xj, alphai, bi, bj, ids,
                   steps, b) -> PoWFStage2:
    r = F.random(curve.fn, generator, (STAGE2_NONCES,) + xi.shape[:-1],
                 xi.device)
    return gen_powfstage2_from(curve, r, pts, xi, xj, alphai, bi, bj, ids,
                               steps, b)


def ver_powfstage2(curve: Curve, proof: PoWFStage2, pts, ids, steps=None):
    """Verify the sixteen equations -> bool (...,)."""
    fn = curve.fn
    eps = list(proof[:16])
    ch = fs_challenge(curve, eps + [pts[k] for k in STAGE2_FS_PTS], ids,
                      TAG_STAGE2, steps)
    ch1 = F.sub(fn, F.sub(fn, ch, proof.ch2), proof.ch3)
    scal = {
        "s11": proof.rho11, "s12": proof.rho12, "s13": proof.rho13,
        "s21": proof.rho21, "s22": proof.rho22, "s23": proof.rho23,
        "s31": proof.rho31, "s32": proof.rho32,
        "t1": ch1, "t2": proof.ch2, "t3": proof.ch3,
    }
    return _eq_all(curve, _stage2_eqs(curve, pts, scal), eps)
