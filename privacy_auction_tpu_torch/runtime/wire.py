"""Canonical wire serialization for bulletin-board messages, in PyTorch.

Counterpart of `privacy_auction_tpu/runtime/wire.py`.  The reference
serializes every EC point as a 65-byte SEC1 uncompressed octet string and
every scalar as its big-endian byte string when metering board traffic
(`SEAL/bulletinBoard.cpp:275-288`).  This module packs whole messages (the
NamedTuples of `protocols/seal.py`) into exactly that format, so the bytes
the native hub meters for a multi-process auction are the reference's cost
model measured for real: 65 B per point, 32 B per scalar.

Leaf convention: a tensor whose trailing dims are (3, LIMBS) is a batch of
projective points; trailing (LIMBS,) is a batch of scalars.  Infinity
encodes as 65 zero bytes (`ec.serialize_uncompressed`).  Leaves are taken
in the order `jax.tree.leaves` takes them from the JAX package's messages
(field order, nested NamedTuples depth first, None skipped), and the port's
message types have the JAX package's fields in the same order, so one
message packs to the same bytes in both packages.
"""

from __future__ import annotations

import torch

from ..curves import Curve
from ..ops import ec
from ..ops import field as F

LIMBS = F.LIMBS
POINT_BYTES = 65
SCALAR_BYTES = 32


def _is_point_leaf(shape) -> bool:
    return len(shape) >= 2 and tuple(shape[-2:]) == (3, LIMBS)


def leaves(tree) -> list:
    """The tensors of a message in leaf order: a NamedTuple's or tuple's
    fields in order, nested ones depth first, None skipped."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [leaf for t in tree for leaf in leaves(t)]
    raise TypeError(f"not a message leaf: {type(tree).__name__}")


def _rebuild(template, it):
    """`template` with its tensors replaced, in leaf order, from `it`."""
    if template is None:
        return None
    if isinstance(template, torch.Tensor):
        return next(it)
    parts = [_rebuild(t, it) for t in template]
    return type(template)(*parts) if hasattr(template, "_fields") \
        else type(template)(parts)


def points_to_bytes(curve: Curve, P) -> torch.Tensor:
    """(..., 3, L) projective -> (..., 65) uint8 SEC1 uncompressed."""
    return ec.serialize_uncompressed(curve, P)


def points_from_bytes(raw) -> torch.Tensor:
    """(..., 65) uint8 -> (..., 3, L) int64 projective (Z = 1, or (0:1:0)
    for infinity)."""
    raw = torch.as_tensor(raw, dtype=torch.uint8)
    x = F.from_bytes_be(raw[..., 1:33])
    y = F.from_bytes_be(raw[..., 33:65])
    finite = (raw[..., 0] == 4).unsqueeze(-1)
    z = torch.zeros_like(x)
    z[..., 0] = finite[..., 0].to(F.DTYPE)
    xo = torch.where(finite, x, 0)
    yo = torch.where(finite, y, 0)
    yo[..., 0] = torch.where(finite[..., 0], yo[..., 0], 1)   # inf -> (0, 1, 0)
    return torch.stack([xo, yo, z], dim=-2)


def scalars_to_bytes(v) -> torch.Tensor:
    """(..., L) -> (..., 32) uint8 big-endian."""
    return F.to_bytes_be(v)


def scalars_from_bytes(raw) -> torch.Tensor:
    """(..., 32) uint8 -> (..., L) int64 limbs."""
    return F.from_bytes_be(torch.as_tensor(raw, dtype=torch.uint8))


def _count(shape, point: bool) -> int:
    cnt = 1
    for d in shape[:-2] if point else shape[:-1]:
        cnt *= int(d)
    return cnt


def wire_size(tree) -> int:
    """Exact serialized size in bytes of a message."""
    total = 0
    for leaf in leaves(tree):
        point = _is_point_leaf(leaf.shape)
        total += _count(leaf.shape, point) * (POINT_BYTES if point
                                              else SCALAR_BYTES)
    return total


def pack(curve: Curve, tree) -> bytes:
    """Serialize a message to canonical wire bytes (leaf order).  Every
    point leaf of the message is affinized in one batched inversion, and
    the bytes cross to the host in one copy."""
    ls = leaves(tree)
    if not ls:
        return b""
    pts = [leaf.reshape(-1, 3, LIMBS) for leaf in ls
           if _is_point_leaf(leaf.shape)]
    pbytes = (points_to_bytes(curve, torch.cat(pts)).reshape(-1)
              if pts else None)
    parts, off = [], 0
    for leaf in ls:
        if _is_point_leaf(leaf.shape):
            cnt = _count(leaf.shape, True) * POINT_BYTES
            parts.append(pbytes[off:off + cnt])
            off += cnt
        else:
            parts.append(scalars_to_bytes(leaf).reshape(-1))
    return torch.cat(parts).cpu().numpy().tobytes()


def unpack(curve: Curve, template, data: bytes, device=None):
    """Deserialize wire bytes into the shape of `template` (a message with
    the SAME shapes as the sender's: protocol messages have static shapes
    given (n, c)).  The tensors land on `device`, by default the template's
    first leaf's."""
    del curve  # the encoding does not depend on the curve
    ls = leaves(template)
    if device is None:
        device = ls[0].device if ls else "cpu"
    raw = torch.frombuffer(bytearray(data), dtype=torch.uint8) if data \
        else torch.zeros(0, dtype=torch.uint8)
    out, off = [], 0
    for leaf in ls:
        shape = tuple(leaf.shape)
        if _is_point_leaf(shape):
            cnt = _count(shape, True) * POINT_BYTES
            part = raw[off:off + cnt].reshape(shape[:-2] + (POINT_BYTES,))
            out.append(points_from_bytes(part))
        else:
            cnt = _count(shape, False) * SCALAR_BYTES
            part = raw[off:off + cnt].reshape(shape[:-1] + (SCALAR_BYTES,))
            out.append(scalars_from_bytes(part))
        off += cnt
    if off != len(data):
        raise ValueError(f"wire message size mismatch: {off} != {len(data)}")
    return _rebuild(template, iter(t.to(device) for t in out))
