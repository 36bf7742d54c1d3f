"""Batched SHA-256, for the Fiat-Shamir challenges and CCS22's
commitment hash.

Counterpart of `privacy_auction_tpu/ops/sha256.py`: one hash state per
batch lane, every lane hashing a message of the same static length.
`sha256` dispatches by device: a CUDA tensor goes to the hand-written
kernel (`cuda_ec.sha256`, csrc/sha256.cu: 32 messages a block, a warp
that runs only the rounds fed through shared memory by warps that load
and expand the message; one launch, capture-safe), on any curve, since
the hash does not depend on
it; a CPU tensor takes the plain version, `sha256_plain`.  There is no
fallback: a failed build or launch raises.

The plain version pads with a constant kept on each device it is used on
and unrolls the rounds into eager ops; its 32-bit words are held in int64
and masked after each sum (torch on the CPU has no uint32 shift), and a
rotation reads the low half of the word duplicated into 64 bits.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import cuda_ec

M32 = 0xFFFFFFFF

_K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)

_H0 = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)


def _rot(x, *ks):
    """XOR of rotr(x, k) over ks, for 32-bit x (unmasked above bit 31)."""
    xx = x | (x << 32)
    out = xx >> ks[0]
    for k in ks[1:]:
        out = out ^ (xx >> k)
    return out


def _compress(state, w):
    """One block: state (8 words) and w (16 words), lists of (...) tensors."""
    a, b, c, d, e, f, g, h = state
    w = list(w)
    for t in range(64):
        if t >= 16:
            w15, w2 = w[t - 15], w[t - 2]
            s0 = _rot(w15, 7, 18) ^ (w15 >> 3)
            s1 = _rot(w2, 17, 19) ^ (w2 >> 10)
            w.append((w[t - 16] + (s0 & M32) + w[t - 7] + (s1 & M32)) & M32)
        S1 = _rot(e, 6, 11, 25) & M32
        ch = g ^ (e & (f ^ g))
        temp1 = h + S1 + ch + (w[t] + _K[t])
        S0 = _rot(a, 2, 13, 22) & M32
        maj = (a & b) | (c & (a | b))
        h, g, f = g, f, e
        e = (d + temp1) & M32
        d, c, b = c, b, a
        a = (temp1 + S0 + maj) & M32
    return [(x + y) & M32 for x, y in zip(state, (a, b, c, d, e, f, g, h))]


def _padding_bytes(msg_len: int) -> np.ndarray:
    """Static SHA-256 padding for a message of msg_len bytes."""
    pad_len = (56 - (msg_len + 1)) % 64
    pad = np.zeros(1 + pad_len + 8, dtype=np.uint8)
    pad[0] = 0x80
    bitlen = msg_len * 8
    for i in range(8):
        pad[1 + pad_len + i] = (bitlen >> (8 * (7 - i))) & 0xFF
    return pad


@functools.lru_cache(maxsize=None)
def _padding(msg_len: int, device: torch.device) -> torch.Tensor:
    """`_padding_bytes` as a cached uint8 tensor on `device` (never
    written to)."""
    return torch.from_numpy(_padding_bytes(msg_len)).to(device)


def sha256(msg: torch.Tensor) -> torch.Tensor:
    """SHA-256 of byte messages: (..., L) uint8 -> (..., 8) int64 digest words
    (big-endian H0..H7, each in [0, 2**32)); the kernel off the CPU."""
    if msg.device.type == "cpu":
        return sha256_plain(msg)
    return cuda_ec.sha256(msg)


def sha256_plain(msg: torch.Tensor) -> torch.Tensor:
    """`sha256` in eager PyTorch ops, on any device."""
    L = msg.shape[-1]
    batch = msg.shape[:-1]
    pad = _padding(L, msg.device)
    full = torch.cat([msg, pad.expand(batch + pad.shape)], dim=-1).to(torch.int64)
    nblocks = full.shape[-1] // 64
    by = full.reshape(batch + (nblocks, 16, 4))
    words = (by[..., 0] << 24) | (by[..., 1] << 16) | (by[..., 2] << 8) | by[..., 3]
    state = [torch.full(batch, h, dtype=torch.int64, device=msg.device)
             for h in _H0]
    for blk in range(nblocks):
        state = _compress(state, words[..., blk, :].unbind(-1))
    return torch.stack(state, dim=-1)


def digest_to_scalar(spec, digest):
    """Digest words (..., 8) -> field element mod spec (BN_bin2bn + BN_mod):
    the 32 digest bytes as a big-endian integer, reduced once (< 2m)."""
    from . import field as F

    return F.from_random_bits(spec, digest.flip(-1))
