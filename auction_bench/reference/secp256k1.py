"""secp256k1 in Python integers: the plain reference's curve arithmetic.

Points are affine pairs (x, y), or None for the point at infinity, at the
edges; inside a multiplication they are Jacobian triples (X, Y, Z) with
x = X / Z^2, y = Y / Z^3 (Z = 0: infinity).  Fixed bases (the generator and
CCS22's g1 and h) use a comb of 8-bit windows built once a base; variable
bases a sum of products, each scalar split by the GLV endomorphism into
two halves of at most 129 bits, over width-5 NAFs with every doubling
shared.  Nothing here is constant-time: it judges public boards.
"""

from __future__ import annotations

import hashlib

P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
B = 7
G = (0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
     0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8)
NAME = "secp256k1"

_INF = (1, 1, 0)


def on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - B) % P == 0


def neg(pt):
    return None if pt is None else (pt[0], (-pt[1]) % P)


def add(p1, p2):
    """Affine sum (one inversion)."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = 3 * x1 * x1 * pow(2 * y1, -1, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return x3, (lam * (x1 - x3) - y1) % P


def sub(p1, p2):
    return add(p1, neg(p2))


def _jdbl(p1):
    X, Y, Z = p1
    if Z == 0 or Y == 0:
        return _INF
    YY = Y * Y % P
    S = 4 * X * YY % P
    M = 3 * X * X % P
    X3 = (M * M - 2 * S) % P
    return X3, (M * (S - X3) - 8 * YY * YY) % P, 2 * Y * Z % P


def _jadd_affine(p1, q):
    """Jacobian + affine (q not infinity)."""
    X1, Y1, Z1 = p1
    x2, y2 = q
    if Z1 == 0:
        return x2, y2, 1
    ZZ = Z1 * Z1 % P
    U2 = x2 * ZZ % P
    S2 = y2 * ZZ * Z1 % P
    H = (U2 - X1) % P
    R = (S2 - Y1) % P
    if H == 0:
        return _jdbl(p1) if R == 0 else _INF
    HH = H * H % P
    HHH = H * HH % P
    V = X1 * HH % P
    X3 = (R * R - HHH - 2 * V) % P
    return X3, (R * (V - X3) - Y1 * HHH) % P, Z1 * H % P


def _jadd(p1, p2):
    X2, Y2, Z2 = p2
    if Z2 == 0:
        return p1
    X1, Y1, Z1 = p1
    if Z1 == 0:
        return p2
    Z1Z1 = Z1 * Z1 % P
    Z2Z2 = Z2 * Z2 % P
    U1 = X1 * Z2Z2 % P
    U2 = X2 * Z1Z1 % P
    S1 = Y1 * Z2 * Z2Z2 % P
    S2 = Y2 * Z1 * Z1Z1 % P
    H = (U2 - U1) % P
    R = (S2 - S1) % P
    if H == 0:
        return _jdbl(p1) if R == 0 else _INF
    HH = H * H % P
    HHH = H * HH % P
    V = U1 * HH % P
    X3 = (R * R - HHH - 2 * V) % P
    return X3, (R * (V - X3) - S1 * HHH) % P, Z1 * Z2 * H % P


def to_affine(pj):
    X, Y, Z = pj
    if Z == 0:
        return None
    zi = pow(Z, -1, P)
    zi2 = zi * zi % P
    return X * zi2 % P, Y * zi2 * zi % P


def _naf(k: int, w: int = 5) -> list[int]:
    """Width-w NAF digits of k >= 0, least significant first."""
    out = []
    half, full = 1 << (w - 1), 1 << w
    while k:
        if k & 1:
            d = k & (full - 1)
            if d >= half:
                d -= full
            k -= d
        else:
            d = 0
        out.append(d)
        k >>= 1
    return out


def _odd_multiples(pt, count: int = 8):
    """[1P, 3P, ..., (2 count - 1)P] affine (none is infinity for a point
    of prime order and count << N)."""
    two = add(pt, pt)
    out = [pt]
    for _ in range(count - 1):
        out.append(add(out[-1], two))
    return out


class Comb:
    """k * base by 32 windows of 8 bits over a table of affine multiples:
    entry [w][d - 1] = d * 2^(8w) * base."""

    def __init__(self, base):
        self.table = []
        b = base
        for _ in range(32):
            row, acc = [], None
            for _ in range(255):
                acc = add(acc, b)
                row.append(acc)
            self.table.append(row)
            for _ in range(8):
                b = add(b, b)

    def mul_j(self, k: int):
        k %= N
        acc = _INF
        w = 0
        while k:
            d = k & 0xFF
            if d:
                acc = _jadd_affine(acc, self.table[w][d - 1])
            k >>= 8
            w += 1
        return acc

    def mul(self, k: int):
        return to_affine(self.mul_j(k))


# GLV: phi(x, y) = (BETA x, y) = LAMBDA (x, y); k = k1 + k2 LAMBDA (mod N)
# with |k1|, |k2| < 2^129, from the short basis (A1, B1), (A2, B2)
LAMBDA = 0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72
BETA = 0x7AE96A2B657C07106E64479EAC3434E99CF0497512F58995C1396C28719501EE
A1 = 0x3086D221A7D46BCDE86C90E49284EB15
B1 = -0xE4437ED6010E88286F547FA90ABFE4C3
A2 = 0x114CA50F7A8E2F3F657C1108D9D44CFD8
B2 = A1


def glv_split(k: int) -> tuple[int, int]:
    """(k1, k2), k = k1 + k2 * LAMBDA (mod N), both of at most 129 bits."""
    k %= N
    c1 = (B2 * k + N // 2) // N
    c2 = (-B1 * k + N // 2) // N
    return k - c1 * A1 - c2 * A2, -c1 * B1 - c2 * B2


def lin_j(terms, tables=None):
    """sum k_i * P_i (affine P_i, None allowed) as a Jacobian point: each
    term split by GLV into two of at most 129 bits, all doublings shared
    (Straus over width-5 NAFs).  `tables`: a dict that keeps each base's
    odd multiples across calls."""
    if tables is None:
        tables = {}
    nafs, tabs = [], []
    for k, pt in terms:
        k %= N
        if pt is None or k == 0:
            continue
        if pt not in tables:
            tables[pt] = _odd_multiples(pt)
        table = tables[pt]
        k1, k2 = glv_split(k)
        for part, phi in ((k1, False), (k2, True)):
            if part == 0:
                continue
            sign = -1 if part < 0 else 1
            nafs.append(_naf(abs(part)))
            tabs.append((table, phi, sign))
    if not nafs:
        return _INF
    acc = _INF
    for i in range(max(len(d) for d in nafs) - 1, -1, -1):
        acc = _jdbl(acc)
        for digits, (table, phi, sign) in zip(nafs, tabs):
            if i < len(digits) and digits[i]:
                d = digits[i] * sign
                x, y = table[abs(d) >> 1]
                if phi:
                    x = x * BETA % P
                acc = _jadd_affine(acc, (x, y if d > 0 else P - y))
    return acc


def mul(k: int, pt):
    return to_affine(lin_j([(k, pt)]))


class Bases:
    """The fixed bases of one check, each with its comb, made once."""

    def __init__(self):
        self._combs = {}

    def comb(self, pt) -> Comb:
        if pt not in self._combs:
            self._combs[pt] = Comb(pt)
        return self._combs[pt]

    def lin(self, fixed, var, tables=None):
        """sum of k * F over `fixed` (pairs (k, F), F a fixed base) and of
        k * P over `var` (pairs (k, P), P any affine point) -> affine."""
        acc = lin_j(var, tables)
        for k, base in fixed:
            acc = _jadd(acc, self.comb(base).mul_j(k))
        return to_affine(acc)


def hash_to_curve(label: bytes):
    """Try-and-increment: x = SHA256(domain | curve | label | counter) mod
    p, the point with even y where x^3 + 7 is a square."""
    domain = b"privacy-auction-tpu/hash-to-curve/v1"
    for counter in range(1 << 16):
        h = hashlib.sha256(domain + b"|" + NAME.encode() + b"|" + label + b"|"
                           + counter.to_bytes(4, "big")).digest()
        x = int.from_bytes(h, "big") % P
        v = (x * x * x + B) % P
        y = pow(v, (P + 1) // 4, P)
        if y * y % P == v:
            return x, (P - y if y & 1 else y)
    raise RuntimeError("hash_to_curve: no point found")


def encode(pt) -> bytes:
    """SEC1 uncompressed, 65 bytes; infinity is 65 zero bytes."""
    if pt is None:
        return bytes(65)
    return b"\x04" + pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")


def batch_affine(triples):
    """Homogeneous projective (X, Y, Z) ints, x = X/Z -> affine points (or
    None), with one inversion for the batch (Montgomery's trick)."""
    zs = [t[2] % P for t in triples]
    prefix, acc = [], 1
    for z in zs:
        prefix.append(acc)
        if z:
            acc = acc * z % P
    inv = pow(acc, -1, P)
    out = [None] * len(triples)
    for i in range(len(triples) - 1, -1, -1):
        z = zs[i]
        if not z:
            continue
        zi = inv * prefix[i] % P
        inv = inv * z % P
        X, Y, _ = triples[i]
        out[i] = (X * zi % P, Y * zi % P)
    return out
