"""The port's wire format (`privacy_auction_tpu_torch/runtime/wire.py`)
gives the JAX package's bytes: four board messages built from the golden
limbs of tests/data/torch_golden_seal.npz (the two-bidder commitment,
bidder 0's round-one keys at step 1, both bidders' Stage1 round two and
bidder 1's Stage2 round two), packed by the port, equal what the JAX
package's `wire.pack` wrote (tests/data/torch_golden_wire.npz, from
tools/torch_golden.py); `wire_size` agrees, and `unpack` gives back the
same points (affine, Z = 1) and the same scalars, which pack to the same
bytes again."""

import pathlib

import numpy as np
import torch

from privacy_auction_tpu_torch import nizk
from privacy_auction_tpu_torch.curves import SECP256K1 as C
from privacy_auction_tpu_torch.ops import ec
from privacy_auction_tpu_torch.protocols import seal
from privacy_auction_tpu_torch.runtime import wire
from torch_golden_cases import g, proof

torch.set_num_threads(1)

WIRE = np.load(pathlib.Path(__file__).resolve().parent / "data"
               / "torch_golden_wire.npz")


def _messages():
    """The four messages of tools/torch_golden.py's `wire_arrays`."""
    ce, cr = g("commit_pok.eps"), g("commit_pok.rho")   # (a/b, n, c, ...)
    re_, rr = g("r1_pok.eps"), g("r1_pok.rho")          # (x/r, c, n, ...)
    stage2 = proof(nizk.PoWFStage2, "stage2")
    return {
        "commit": seal.CommitmentPub(
            phi=g("phi"), A=g("A"), B=g("B"),
            pok_a=nizk.PoKDLog(ce[0], cr[0]), pok_b=nizk.PoKDLog(ce[1], cr[1]),
            powf=proof(nizk.PoWFCom, "powf")),
        "round1": seal.RoundOnePub(
            X=g("X")[1, 0:1], R=g("R")[1, 0:1],
            pok_x=nizk.PoKDLog(re_[0, 1, 0:1], rr[0, 1, 0:1]),
            pok_r=nizk.PoKDLog(re_[1, 1, 0:1], rr[1, 1, 0:1])),
        "stage1": seal.RoundTwoPub(b=g("stage1_b"),
                                   proof1=proof(nizk.PoWFStage1, "stage1"),
                                   proof2=None),
        "stage2": seal.RoundTwoPub(
            b=g("stage2_b")[1:2], proof1=None,
            proof2=type(stage2)(*(t[1:2] for t in stage2))),
    }


def test_wire_bytes_match_jax():
    for name, msg in _messages().items():
        want = WIRE[f"wire.{name}"].tobytes()
        data = wire.pack(C, msg)
        assert data == want, name
        assert wire.wire_size(msg) == len(want) == int(WIRE[f"wire.{name}.size"])
        back = wire.unpack(C, msg, data)
        assert wire.pack(C, back) == data, name
        sent, got = wire.leaves(msg), wire.leaves(back)
        assert len(sent) == len(got)
        for a, b in zip(sent, got):
            assert a.shape == b.shape and b.dtype == torch.int64
            if a.shape[-2:] == (3, 16):
                assert bool(ec.eq(C, a, b).all()), name
                assert bool((b[..., 2, 0] == 1).all())
            else:
                assert torch.equal(a, b), name
    # infinity: 65 zero bytes on the wire, (0:1:0) back
    inf = seal.RoundTwoPub(b=ec.infinity("cpu", (2,)), proof1=None, proof2=None)
    data = wire.pack(C, inf)
    assert data == bytes(2 * wire.POINT_BYTES)
    assert torch.equal(wire.unpack(C, inf, data).b, ec.infinity("cpu", (2,)))
