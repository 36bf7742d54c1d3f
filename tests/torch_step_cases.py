"""Loader of the golden vectors that tools/torch_golden.py wrote for SEAL's
fused step (tests/data/torch_golden_seal_step.npz): the JAX scan body's
inputs and outputs at bids [5, 3, 6], c = 3, and `full_step`,
`step_stage1`, `step_stage2` and `ec.serialize_affine` with their nonces.
Limb arrays come back as the port's int64 tensors through
`privacy_auction_tpu_torch.interop`."""

import pathlib

import numpy as np
import torch

from privacy_auction_tpu_torch import interop, nizk
from privacy_auction_tpu_torch.protocols import seal

GOLD = np.load(pathlib.Path(__file__).resolve().parent / "data"
               / "torch_golden_seal_step.npz")
BIDS = [int(b) for b in GOLD["bids"]]
C_BITS = int(GOLD["c"])
N = len(BIDS)
IDS = torch.arange(N)
# the nested NamedTuples of the recorded structures, by field
NESTED = {"pok_a": nizk.PoKDLog, "pok_b": nizk.PoKDLog, "powf": nizk.PoWFCom}


def g(name):
    return interop.to_torch(GOLD[name], device="cpu")


def tree(cls, prefix):
    """The port's `cls` of the arrays recorded under `prefix`."""
    return cls(**{f: tree(NESTED[f], f"{prefix}.{f}") if f in NESTED
                  else g(f"{prefix}.{f}") for f in cls._fields})


def bits():
    return torch.as_tensor(seal.bids_to_bits(BIDS, C_BITS))


def draws(prefix):
    return seal.StepDraws(*(g(f"{prefix}.draw.{k}") for k in ("xr", "v", "r")))


def assert_same(got, prefix):
    """Every tensor of a (nested) port NamedTuple, or a tensor, equals the
    recorded array under `prefix`."""
    if isinstance(got, torch.Tensor):
        np.testing.assert_array_equal(got.numpy(), g(prefix).numpy(),
                                      err_msg=prefix)
        return
    for f, v in got._asdict().items():
        assert_same(v, f"{prefix}.{f}")
