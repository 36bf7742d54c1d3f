"""Carry state between the JAX package and the PyTorch port.

Both packages keep the same layout at every public function: scalars are
(..., 16) and points (..., 3, 16) 16-bit little-endian limbs, points
projective with Z = 0 at infinity.  The JAX package holds limbs as uint32,
the port as int64.  These helpers convert arrays taken as numpy, and the
SEAL and CCS22 board NamedTuples, by value in both directions, so a board one package
writes can be checked by the other.  They import nothing of the JAX
package: a NamedTuple is matched to the port's type of the same name, and
on the way back the caller names the target types.
"""

from __future__ import annotations

import numpy as np
import torch

from . import nizk
from .protocols import ccs22, seal

BOARD_TYPES = {
    t.__name__: t for t in (
        nizk.PoKDLog, nizk.PoWFCom, nizk.PoWFStage1, nizk.PoWFStage2,
        seal.CommitmentPub, seal.CommitmentSec, seal.RoundOnePub,
        seal.RoundOneSec, seal.StepInfo,
        ccs22.PubParams, ccs22.SetupPub, ccs22.SetupSec, ccs22.OTR1,
        ccs22.OTS,
    )
}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def to_torch(x, device="cuda"):
    """numpy-like arrays (or a board NamedTuple of them, from either
    package) -> int64 tensors (or the port's NamedTuple) on `device`, the
    GPU unless the caller asks for the CPU.  Boolean arrays stay boolean."""
    if _is_namedtuple(x):
        cls = BOARD_TYPES[type(x).__name__]
        return cls(**{k: to_torch(v, device) for k, v in x._asdict().items()})
    arr = np.asarray(x)
    dtype = torch.bool if arr.dtype == np.bool_ else torch.int64
    return torch.as_tensor(arr.astype(np.bool_ if dtype is torch.bool
                                      else np.int64)).to(device, dtype)


def to_numpy(x, types=None):
    """Port tensors (or a board NamedTuple) -> numpy uint32 limb arrays, the
    JAX package's dtype; booleans stay boolean.  `types` maps NamedTuple
    names to the target classes (e.g. the JAX package's); without it the
    port's own NamedTuple types are kept."""
    if _is_namedtuple(x):
        cls = (types or BOARD_TYPES)[type(x).__name__]
        return cls(**{k: to_numpy(v, types) for k, v in x._asdict().items()})
    t = torch.as_tensor(x).cpu()
    if t.dtype == torch.bool:
        return t.numpy()
    arr = t.to(torch.int64).numpy()
    if arr.size and (arr.min() < 0 or arr.max() >= (1 << 32)):
        raise ValueError("value out of uint32 range")
    return arr.astype(np.uint32)
