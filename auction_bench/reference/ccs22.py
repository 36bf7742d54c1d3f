"""Plain reference of a CCS22 auction (eprint 2022/1541) with a random
evaluator: judges the outcome and the published board of one auction.

The protocol publishes no proof, so the reference works the board out
again from the auction's inputs: the bids, the evaluator's lane and the
seed of the nonce generator.  It draws every scalar again from that seed
as the program's `run_auction(generator=...)` documents its draws: a CPU
`torch.Generator`, 8 words of 32 bits a scalar from `torch.randint`, least
significant first, reduced mod the group order, in the order beta (n, c);
x, r, s, t (4, n, c); rcom (n,); k, m1 (2, n, c).

The outcome: the announced bits are those of the plaintext maximum, the
maximum their value.  The board, for the sampled (bidder, step) lanes:
X = g^x; with the AV-net key Y of the step (from the published X of every
bidder at that step) and d = bit AND in-race, B = x Y (d = 0) or g^r
(d = 1); the evaluator's choice alpha = its own d; T2 = g^k,
G = g^beta + alpha g1, H = h^beta + alpha T2, z = g^s + h^t,
C0 = s G + t H + B, C1 = s (G - g1) + t (H - T2) + g^m1.  And the
commitments of the sampled bidders and the evaluator: g^bid + g1^Hash +
h^rcom, Hash = SHA-256 of the lane's x, r, s, t (32 big-endian bytes a
scalar, c of each), the evaluator's followed by every lane's beta.
"""

from __future__ import annotations

import hashlib

import torch

from . import limbs
from . import secp256k1 as E
from .seal import plain_bits

G1 = E.hash_to_curve(b"ccs22-crs-g1")
H = E.hash_to_curve(b"ccs22-crs-h")
WORDS = 8


def draw_words(seed: int, n: int, c: int) -> dict:
    """The random words of every scalar of one auction, by name."""
    gen = torch.Generator().manual_seed(seed)

    def words(*shape):
        return torch.randint(0, 1 << 32, shape + (WORDS,), generator=gen,
                             dtype=torch.int64).numpy()

    beta = words(n, c)
    xrst = words(4, n, c)
    rcom = words(n)
    km = words(2, n, c)
    return {"beta": beta, "x": xrst[0], "r": xrst[1], "s": xrst[2],
            "t": xrst[3], "rcom": rcom, "k": km[0], "m1": km[1]}


def scalar(w) -> int:
    return sum(int(v) << (32 * i) for i, v in enumerate(w)) % E.N


def _be(v: int) -> bytes:
    return v.to_bytes(32, "big")


def _race(bids, c: int):
    """(d, announced): d[j][i] = bit AND in-race, and the announced bits,
    from the plaintext bids."""
    n = len(bids)
    in_race = [1] * n
    d_all, ann = [], []
    for j in range(c):
        d = [((b >> (c - 1 - j)) & 1) & r for b, r in zip(bids, in_race)]
        a = int(any(d))
        if a:
            in_race = d
        d_all.append(d)
        ann.append(a)
    return d_all, ann


def _avnet_key(X: list, i: int):
    """Y_i = sum_{l<i} X_l - sum_{l>i} X_l (Jacobian sums)."""
    before, after = E._INF, E._INF
    for l, x in enumerate(X):
        if x is None or l == i:
            continue
        if l < i:
            before = E._jadd_affine(before, x)
        else:
            after = E._jadd_affine(after, x)
    return E.sub(E.to_affine(before), E.to_affine(after))


def check(board: dict, bids, c: int, eval_id: int, nonce_seed: int, lanes,
          bases: E.Bases) -> dict:
    """Judge one auction.  board: the host copy of what `drivers/ccs22.py`
    kept (`keep`, `to_host`); lanes: (bidder, step) pairs.  Returns
    {"outcome": [...], "board": [...]}, each a list of what did not hold."""
    n = len(bids)
    bad = {"outcome": [], "board": []}
    want = plain_bits(bids, c)
    d_all, ann = _race(bids, c)
    deciding = [int(v) for v in board["deciding"]]
    if board["max_bid"] != max(bids):
        bad["outcome"].append(f"max_bid {board['max_bid']} != {max(bids)}")
    if deciding != want or ann != want:
        bad["outcome"].append("announced bits")
    if board["rows"] != n:
        bad["board"].append(f"board of {board['rows']} bidders, want {n}")
        return bad

    w = draw_words(nonce_seed, n, c)
    ev = eval_id

    # commitments: each sampled bidder's and the evaluator's
    for row, i in enumerate(board["com_bidders"]):
        msg = b"".join(_be(scalar(w[k][i, j])) for k in "xrst"
                       for j in range(c))
        if i == ev:
            msg += b"".join(_be(scalar(v)) for v in w["beta"].reshape(-1, WORDS))
        hsh = int.from_bytes(hashlib.sha256(msg).digest(), "big") % E.N
        com = bases.lin([(bids[i] % E.N, E.G), (hsh, G1),
                         (scalar(w["rcom"][i]), H)], [])
        if limbs.points(board["com"][row])[0] != com:
            bad["board"].append(f"commitment of bidder {i}")

    cols = {j: col for col, j in enumerate(board["steps"])}
    Xcol = {j: limbs.points(board["X_steps"][:, col]) for j, col in cols.items()}
    got = {k: limbs.points(v) for k, v in board["lanes"].items()}
    for row, (i, j) in enumerate(lanes):
        sv = {k: scalar(w[k][i, j]) for k in ("x", "r", "s", "t", "k", "m1",
                                                "beta")}
        X = Xcol[j]
        tables = {}
        failed = []
        if X[i] != bases.lin([(sv["x"], E.G)], []):
            failed.append("X")
        Y = _avnet_key(X, i)
        if d_all[j][i] == 0:
            B = bases.lin([], [(sv["x"], Y)], tables)
        else:
            B = bases.lin([(sv["r"], E.G)], [])
        alpha = d_all[j][ev]
        T2 = bases.lin([(sv["k"], E.G)], [])
        Gm = bases.lin([(sv["beta"], E.G), (alpha, G1)], [])
        Hm = E.add(bases.lin([(sv["beta"], H)], []), T2 if alpha else None)
        z = bases.lin([(sv["s"], E.G), (sv["t"], H)], [])
        C0 = E.add(bases.lin([], [(sv["s"], Gm), (sv["t"], Hm)], tables), B)
        C1 = bases.lin([(sv["m1"], E.G)], [(sv["s"], E.sub(Gm, G1)),
                                           (sv["t"], E.sub(Hm, T2))], tables)
        for name, v in (("T2", T2), ("G", Gm), ("H", Hm), ("z", z),
                        ("C0", C0), ("C1", C1)):
            if got[name][row] != v:
                failed.append(name)
        bad["board"] += [f"lane ({i}, {j}) {f}" for f in failed]
    return bad
