"""Plain reference of a verified SEAL auction (eprint 2019/1332): judges
the outcome and the published board of one auction.

The outcome: verified, the maximum equal to the plaintext maximum of the
bids, and the deciding bits its bits, most significant first.  The board,
for every step: the veto sum of the round-two ciphertexts is not infinity
exactly where the step decided.  For each sampled (bidder, step) lane: the
commitment's two PoKDLogs and its PoWFCom, round one's two PoKDLogs, and
round two's Stage1 (before the first deciding step) or Stage2 proof, each
verified from its Fiat-Shamir transcript (hashlib) and its equations.

Transcripts: domain tag, the 65-byte uncompressed generator, the 65-byte
uncompressed points in proof order (infinity as 65 zero bytes), the prover
id as 8 little-endian bytes, the step as 4 little-endian bytes; the
challenge is the digest as a big-endian integer mod the group order.
"""

from __future__ import annotations

import hashlib

from . import limbs
from . import secp256k1 as E

TAG_POKDLOG = b"PA/PoKDLog\x00"
TAG_POWFCOM = b"PA/PoWFCom\x00"
TAG_STAGE1 = b"PA/PoWFStage1\x00"
TAG_STAGE2 = b"PA/PoWFStage2\x00"
_G_OCTETS = E.encode(E.G)

STAGE1_EPS = ("eps11", "eps12", "eps13", "eps14", "eps21", "eps22", "eps23",
              "eps24")
STAGE2_EPS = ("eps11", "eps12", "eps13", "eps11p", "eps12p", "eps13p",
              "eps21", "eps22", "eps23", "eps21p", "eps22p", "eps23p",
              "eps31", "eps32", "eps31p", "eps32p")
POWFCOM_EPS = ("eps11", "eps12", "eps21", "eps22")


def challenge(tag: bytes, pts, pid: int, step: int) -> int:
    data = b"".join([tag, _G_OCTETS, *(E.encode(p) for p in pts),
                     (pid & 0xFFFFFFFF).to_bytes(8, "little"),
                     (step & 0xFFFFFFFF).to_bytes(4, "little")])
    return int.from_bytes(hashlib.sha256(data).digest(), "big") % E.N


def plain_bits(bids, c: int) -> list[int]:
    top = max(bids)
    return [(top >> (c - 1 - j)) & 1 for j in range(c)]


def avnet_keys(X: list) -> list:
    """Y_i = sum_{l<i} X_l - sum_{l>i} X_l."""
    total = None
    for x in X:
        total = E.add(total, x)
    out, before = [], None
    for x in X:
        after = E.sub(E.sub(total, before), x)
        out.append(E.sub(before, after))
        before = E.add(before, x)
    return out


class _Lane:
    """One (bidder, step) lane's checks; every equation eps == base1^s *
    base2^t, base1 = None meaning the generator."""

    def __init__(self, bases: E.Bases):
        self.bases = bases
        self.tables = {}
        self.failed = []

    def eq(self, what, eps, b1, s, b2, t):
        fixed = [(s, E.G)] if b1 is None else []
        var = ([] if b1 is None else [(s, b1)]) + [(t, b2)]
        if self.bases.lin(fixed, var, self.tables) != eps:
            self.failed.append(what)


def _pokdlog(lane, what, eps, rho, X, pid, step):
    ch = challenge(TAG_POKDLOG, [eps, X], pid, step)
    lane.eq(what, eps, None, rho, X, ch)


def check(board: dict, bids, lanes, bases: E.Bases) -> dict:
    """Judge one auction.  board: the host copy of what `drivers/seal.py`
    kept (`keep`, `to_host`): the outcome; every step's X, R and b (c, n,
    ...); the sampled lanes' commitment and round-one proof fields
    (`lanes`, a row a lane), and their round-two proofs (`stage1`,
    `stage2`: the rows of the lanes at that stage, and the fields).
    lanes: the (bidder, step) pairs, in the rows' order.  Returns
    {"outcome": [...], "board": [...]}, each a list of what did not hold."""
    n = len(bids)
    bad = {"outcome": [], "board": []}
    c = len(board["deciding"])
    deciding = [int(v) for v in board["deciding"]]
    if not board["verified"]:
        bad["outcome"].append("not verified")
    if board["max_bid"] != max(bids):
        bad["outcome"].append(f"max_bid {board['max_bid']} != {max(bids)}")
    if deciding != plain_bits(bids, c):
        bad["outcome"].append("deciding bits")
    if board.get("rows") != n:
        bad["board"].append(f"board of {board.get('rows')} bidders, want {n}")
        return bad

    # round three over every step and lane
    b_all = limbs.points(board["b"])                     # (c, n) flattened
    for j in range(c):
        total = None
        for i in range(n):
            total = E.add(total, b_all[j * n + i])
        if (total is not None) != bool(deciding[j]):
            bad["board"].append(f"veto sum step {j}")

    X_all, R_all = limbs.points(board["X"]), limbs.points(board["R"])
    steps_needed = sorted({j for _, j in lanes}
                          | {_prev(deciding, j) for _, j in lanes} - {None})
    Y = {j: avnet_keys(X_all[j * n:(j + 1) * n]) for j in steps_needed}
    at = {}
    for stage in (1, 2):
        part = board.get(f"stage{stage}")
        for k, row in enumerate(part["rows"] if part else []):
            at[row] = (stage, k)

    def pt(key, row, part=None):
        return limbs.points((part or board["lanes"])[key][row])[0]

    def sc(key, row, part=None):
        return limbs.scalars((part or board["lanes"])[key][row])[0]

    for row, (i, j) in enumerate(lanes):
        lane = _Lane(bases)
        # commit: PoKDLog(A), PoKDLog(B), PoWFCom
        phi, A, Bc = (pt(k, row) for k in ("phi", "A", "B"))
        _pokdlog(lane, "pok_a", pt("pok_a_eps", row), sc("pok_a_rho", row),
                 A, i, j)
        _pokdlog(lane, "pok_b", pt("pok_b_eps", row), sc("pok_b_rho", row),
                 Bc, i, j)
        e = [pt("powf_" + k, row) for k in POWFCOM_EPS]
        ch = challenge(TAG_POWFCOM, e + [phi, A, Bc], i, j)
        rho1, rho2, ch2 = (sc("powf_" + k, row) for k in ("rho1", "rho2", "ch2"))
        ch1 = (ch - ch2) % E.N
        lane.eq("powf11", e[0], None, rho1, A, ch1)
        lane.eq("powf12", e[1], Bc, rho1, phi, ch1)
        lane.eq("powf21", e[2], None, rho2, A, ch2)
        lane.eq("powf22", e[3], Bc, rho2, E.sub(phi, E.G), ch2)
        # round one
        Xi, Ri = X_all[j * n + i], R_all[j * n + i]
        _pokdlog(lane, "pok_x", pt("pok_x_eps", row), sc("pok_x_rho", row),
                 Xi, i, j)
        _pokdlog(lane, "pok_r", pt("pok_r_eps", row), sc("pok_r_rho", row),
                 Ri, i, j)
        # round two: Stage1 up to the first deciding step, then Stage2
        jp = _prev(deciding, j)
        stage, k = at.get(row, (None, None))
        bi = b_all[j * n + i]
        if stage != (1 if jp is None else 2):
            lane.failed.append(f"stage {stage} proof at step {j}")
        elif stage == 1:
            _stage1(lane, board["stage1"], k, i, j, bi, Xi, Y[j][i], Ri, phi,
                    A, Bc)
        else:
            pts = dict(Xi=Xi, Ri=Ri, Yi=Y[j][i], Bi=bi, Xj=X_all[jp * n + i],
                       Rj=R_all[jp * n + i], Yj=Y[jp][i], Bj=b_all[jp * n + i],
                       Ci=phi, A=A, B=Bc)
            _stage2(lane, board["stage2"], k, i, j, pts)
        bad["board"] += [f"lane ({i}, {j}) {w}" for w in lane.failed]
    return bad


def _prev(deciding, j):
    """The last deciding step before j, or None."""
    for jp in range(j - 1, -1, -1):
        if deciding[jp]:
            return jp
    return None


def _stage1(lane, proof, row, i, j, b, X, Y, R, cc, A, Bc):
    eps = [limbs.points(proof[k][row])[0] for k in STAGE1_EPS]
    s = {k: limbs.scalars(proof[k][row])[0]
         for k in ("rho11", "rho12", "rho21", "rho22", "ch2")}
    ch = challenge(TAG_STAGE1, eps + [b, X, Y, R, cc, A, Bc], i, j)
    t1, t2 = (ch - s["ch2"]) % E.N, s["ch2"]
    eqs = [(None, s["rho11"], X, t1), (None, s["rho12"], A, t1),
           (Y, s["rho11"], b, t1), (Bc, s["rho12"], cc, t1),
           (None, s["rho21"], X, t2), (None, s["rho22"], A, t2),
           (R, s["rho21"], b, t2), (Bc, s["rho22"], E.sub(cc, E.G), t2)]
    for k, e, eq in zip(STAGE1_EPS, eps, eqs):
        lane.eq("stage1 " + k, e, *eq)


STAGE2_FS_PTS = ("Xi", "Xj", "A", "Bi", "Bj", "B", "Ri", "Rj", "Ci", "Yi", "Yj")


def _stage2(lane, proof, row, i, j, pts):
    eps = [limbs.points(proof[k][row])[0] for k in STAGE2_EPS]
    s = {k: limbs.scalars(proof[k][row])[0]
         for k in ("rho11", "rho12", "rho13", "rho21", "rho22", "rho23",
                   "rho31", "rho32", "ch2", "ch3")}
    ch = challenge(TAG_STAGE2, eps + [pts[k] for k in STAGE2_FS_PTS], i, j)
    t1, t2, t3 = (ch - s["ch2"] - s["ch3"]) % E.N, s["ch2"], s["ch3"]
    p = pts
    eqs = [(None, s["rho11"], p["Xi"], t1), (None, s["rho12"], p["Xj"], t1),
           (None, s["rho13"], p["A"], t1), (p["Ri"], s["rho11"], p["Bi"], t1),
           (p["Rj"], s["rho12"], p["Bj"], t1),
           (p["B"], s["rho13"], E.sub(p["Ci"], E.G), t1),
           (None, s["rho21"], p["Xi"], t2), (None, s["rho22"], p["Xj"], t2),
           (None, s["rho23"], p["A"], t2), (p["Yi"], s["rho21"], p["Bi"], t2),
           (p["Rj"], s["rho22"], p["Bj"], t2), (p["B"], s["rho23"], p["Ci"], t2),
           (None, s["rho31"], p["Xi"], t3), (None, s["rho32"], p["Xj"], t3),
           (p["Yi"], s["rho31"], p["Bi"], t3), (p["Yj"], s["rho32"], p["Bj"], t3)]
    for k, e, eq in zip(STAGE2_EPS, eps, eqs):
        lane.eq("stage2 " + k, e, *eq)
