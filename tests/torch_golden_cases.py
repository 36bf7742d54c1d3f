"""Loader of the golden vectors that tools/torch_golden.py wrote from the JAX
package (tests/data/torch_golden_seal.npz): a two-bidder, two-bit SEAL
board, the nonces each JAX proof generator drew, and a verified auction's
outcome.  Limb arrays come back as the port's int64 tensors through
`privacy_auction_tpu_torch.interop`."""

import pathlib

import numpy as np
import torch

from privacy_auction_tpu_torch import interop

GOLD = np.load(pathlib.Path(__file__).resolve().parent / "data"
               / "torch_golden_seal.npz")
N, C = len(GOLD["board_bids"]), 2
IDS = torch.arange(N)


def g(name):
    return interop.to_torch(GOLD[name], device="cpu")


def proof(cls, prefix):
    """A port NamedTuple of the recorded JAX proof, converted by interop."""
    return interop.to_torch(cls(**{f: GOLD[f"{prefix}.{f}"] for f in cls._fields}),
                            device="cpu")


def bits():
    from privacy_auction_tpu_torch.protocols import seal

    return torch.as_tensor(seal.bids_to_bits(GOLD["board_bids"], C))


def stage1_inputs():
    """Stage1 inputs of step 0 (every bidder's MSB is 1)."""
    x_all = g("r1_xr")[0]
    d0 = bits()[:, 0]
    return dict(X=g("X")[0], Y=g("Y")[0], R=g("R")[0], c=g("phi")[:, 0],
                A=g("A")[:, 0], B=g("B")[:, 0], x=x_all[0], alpha=g("alpha")[:, 0],
                bit=d0, ids=IDS, steps=0, b=g("stage1_b"))


def stage2_inputs():
    """Stage2 inputs of step 1, with step 0 as the deciding step."""
    x_all = g("r1_xr")[0]
    d0 = bits()[:, 0]
    d1 = bits()[:, 1] & d0
    X, R, Y = g("X"), g("R"), g("Y")
    pts = dict(Xi=X[1], Ri=R[1], Yi=Y[1], Bj=g("stage1_b"), Xj=X[0], Rj=R[0],
               Yj=Y[0], Ci=g("phi")[:, 1], A=g("A")[:, 1], B=g("B")[:, 1])
    return dict(pts=pts, xi=x_all[1], xj=x_all[0], alphai=g("alpha")[:, 1],
                bi=d1, bj=d0, ids=IDS, steps=1, b=g("stage2_b"))


def assert_same(port_tuple, jax_prefix):
    for f in port_tuple._fields:
        np.testing.assert_array_equal(
            port_tuple._asdict()[f].numpy(),
            GOLD[f"{jax_prefix}.{f}"].astype(np.int64), err_msg=f)


def tampered(t: torch.Tensor, index):
    """A copy of scalar limbs t with bit 0 of limb 0 flipped at `index`."""
    t = t.clone()
    t[index + (0,)] ^= 1
    return t

