"""Host-side (pure Python int) elliptic-curve arithmetic.

Used for:
  * precomputing fixed-base comb tables at import time (host, exact ints),
  * an independent oracle in tests (differential testing of the CUDA kernels
    and their plain PyTorch versions).

This is NOT the device compute path -- see `privacy_auction_tpu_torch.ops.ec`
for the batched device code.  Plays the role OpenSSL libcrypto plays for the
reference implementation (`SEAL/bidder.cpp:36-44` uses
`EC_GROUP_new_by_curve_name(714)` = secp256k1).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass


@dataclass(frozen=True)
class HostCurve:
    """Short-Weierstrass curve y^2 = x^3 + a*x + b over GF(p), prime order n."""

    name: str
    p: int
    a: int
    b: int
    n: int  # group order
    gx: int
    gy: int

    # ---- field helpers -------------------------------------------------
    def finv(self, x: int) -> int:
        return pow(x, self.p - 2, self.p)

    # ---- group ops on affine points (None == point at infinity) --------
    def is_on_curve(self, P) -> bool:
        if P is None:
            return True
        x, y = P
        return (y * y - (x * x * x + self.a * x + self.b)) % self.p == 0

    def neg(self, P):
        if P is None:
            return None
        x, y = P
        return (x, (-y) % self.p)

    def add(self, P, Q):
        if P is None:
            return Q
        if Q is None:
            return P
        x1, y1 = P
        x2, y2 = Q
        if x1 == x2 and (y1 + y2) % self.p == 0:
            return None
        if P == Q:
            lam = (3 * x1 * x1 + self.a) * self.finv(2 * y1) % self.p
        else:
            lam = (y2 - y1) * self.finv(x2 - x1) % self.p
        x3 = (lam * lam - x1 - x2) % self.p
        y3 = (lam * (x1 - x3) - y1) % self.p
        return (x3, y3)

    def mul(self, k: int, P):
        """Scalar multiplication k*P (double-and-add; host only)."""
        k %= self.n
        R = None
        A = P
        while k:
            if k & 1:
                R = self.add(R, A)
            A = self.add(A, A)
            k >>= 1
        return R

    def sqrt_mod_p(self, v: int):
        """Square root mod p, or None if v is a non-residue."""
        v %= self.p
        if self.p % 4 == 3:
            r = pow(v, (self.p + 1) // 4, self.p)
        else:  # Tonelli-Shanks general case (not needed for secp256k1/P-256)
            raise NotImplementedError("p % 4 != 3")
        return r if r * r % self.p == v else None

    def hash_to_curve(self, label: bytes):
        """Deterministic nothing-up-my-sleeve point via try-and-increment.

        x = SHA256(domain || curve-name || label || counter) mod p, lifted to
        the even-y curve point when x^3 + ax + b is a quadratic residue.
        No party knows the discrete log of the result w.r.t. any generator --
        this does properly what the reference marks FIXME ("should be
        obtained by hashing g", `CCS22/bulletinBoard.cpp:
        30-33,42-45`, where g1/h are g^rand with the trapdoor scalar kept
        alive in the BulletinBoard).
        """
        domain = b"privacy-auction-tpu/hash-to-curve/v1"
        for counter in range(1 << 16):
            h = hashlib.sha256(
                domain + b"|" + self.name.encode() + b"|" + label + b"|"
                + counter.to_bytes(4, "big")
            ).digest()
            x = int.from_bytes(h, "big") % self.p
            y = self.sqrt_mod_p(x * x * x + self.a * x + self.b)
            if y is not None:
                if y & 1:
                    y = self.p - y
                return (x, y)
        raise RuntimeError("hash_to_curve: no point found (unreachable)")

    @property
    def g(self):
        return (self.gx, self.gy)


SECP256K1 = HostCurve(
    name="secp256k1",
    p=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F,
    a=0,
    b=7,
    n=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141,
    gx=0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    gy=0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
)

# NIST P-256 (secp256r1); a != 0 so the device path must use the generic
# complete formulas (RCB15 Algorithm 1) rather than the a=0 fast path.
P256 = HostCurve(
    name="p256",
    p=0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF,
    a=0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFC,
    b=0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B,
    n=0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551,
    gx=0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296,
    gy=0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5,
)

HOST_CURVES = {c.name: c for c in (SECP256K1, P256)}
