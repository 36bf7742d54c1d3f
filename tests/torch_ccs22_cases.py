"""Loader of the CCS22 golden vectors that tools/torch_golden.py wrote from
the JAX package (tests/data/torch_golden_ccs22.npz): the CRS, every scalar
the JAX drivers drew, and the messages and outcomes they gave.  Limb arrays
come back as the port's int64 tensors through
`privacy_auction_tpu_torch.interop`.  Each whole auction on the CPU path
has a test file of its own, so that each file stays short."""

import pathlib

import numpy as np
import torch

from privacy_auction_tpu_torch import interop
from privacy_auction_tpu_torch.curves import SECP256K1 as C
from privacy_auction_tpu_torch.protocols import ccs22

GOLD = np.load(pathlib.Path(__file__).resolve().parent / "data"
               / "torch_golden_ccs22.npz")
BIDS = [int(b) for b in GOLD["bids"]]
N, C_BITS = len(BIDS), int(GOLD["c"])
EVALS = [int(e) for e in GOLD["evals"]]


def g(name, device="cpu"):
    return interop.to_torch(GOLD[name], device=device)


def draws(prefix="draw", device="cpu"):
    """The scalars one JAX auction drew, as the port's `ccs22.Draws`."""
    sec = ccs22.SetupSec(*(g(f"{prefix}.{k}", device)
                           for k in ccs22.SetupSec._fields))
    return ccs22.Draws(beta=g(f"{prefix}.beta", device), sec=sec,
                       k_rand=g(f"{prefix}.k_rand", device),
                       m1k=g(f"{prefix}.m1k", device))


def assert_same(port_tuple, prefix):
    """Every field of a port NamedTuple equals the recorded JAX array."""
    for f, v in port_tuple._asdict().items():
        np.testing.assert_array_equal(
            v.cpu().numpy(), GOLD[f"{prefix}.{f}"].astype(np.int64), err_msg=f)


def bits():
    from privacy_auction_tpu_torch.protocols import seal

    return torch.as_tensor(seal.bids_to_bits(BIDS, C_BITS))


def check_auction(eid):
    """A whole auction on the CPU path at evaluator `eid`, fed the recorded
    scalars, gives the JAX setup messages, per-step OT messages, announced
    bits and max bid."""
    times = {}
    res = ccs22.run_auction(C, BIDS, C_BITS, eid, device="cpu", draws=draws(),
                            phase_times=times)
    assert res.max_bid == int(GOLD[f"e{eid}.max_bid"]) == max(BIDS)
    np.testing.assert_array_equal(res.deciding_bits,
                                  GOLD[f"e{eid}.deciding_bits"])
    np.testing.assert_array_equal(res.board.announced.numpy(),
                                  GOLD[f"e{eid}.announced"])
    assert_same(res.board.setup, f"e{eid}.setup_pub")
    assert_same(res.board.otr1, f"e{eid}.otr1")
    assert_same(res.board.ots, f"e{eid}.ots")
    assert set(times) == {"setup", "precompute", "steps"}


def check_edge(i):
    """The auction of edge case `i` (evaluator 0) gives the JAX outcome and
    the plaintext maximum."""
    bids = [int(b) for b in GOLD[f"edge{i}.bids"]]
    res = ccs22.run_auction(C, bids, 3, 0, device="cpu",
                            draws=draws(f"edge{i}.draw"))
    assert res.max_bid == int(GOLD[f"edge{i}.max_bid"]) == max(bids)
    np.testing.assert_array_equal(res.deciding_bits,
                                  GOLD[f"edge{i}.deciding_bits"])
