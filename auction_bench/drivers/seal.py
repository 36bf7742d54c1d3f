"""SEAL through `privacy_auction_tpu_torch.protocols.seal.run_auction`, the
fused driver, every proof generated and verified (`verify`)."""

from __future__ import annotations

import numpy as np
import torch

from ..reference import seal as ref


def prepare(config: dict, mix, device: str) -> dict:
    from privacy_auction_tpu_torch.curves import get_curve
    from privacy_auction_tpu_torch.protocols import seal

    return {"seal": seal, "curve": get_curve(config["curve"]),
            "verify": bool(config["verify"]), "c": mix.c, "device": device}


def run(state: dict, auction, phase_times=None):
    return state["seal"].run_auction(
        state["curve"], list(auction.bids), state["c"], verify=state["verify"],
        generator=torch.Generator().manual_seed(auction.nonce_seed),
        device=state["device"], phase_times=phase_times)


def _fields(tup, prefix=""):
    """A (nested) NamedTuple of tensors -> {name: tensor}, nested names
    joined by "_"."""
    out = {}
    for name, v in zip(tup._fields, tup):
        if isinstance(v, torch.Tensor):
            out[prefix + name] = v
        else:
            out.update(_fields(v, prefix + name + "_"))
    return out


def keep(result, auction, lanes):
    """What the check reads, gathered on the device (the rest is freed with
    the result): every step's round-one keys X, R and ciphertexts b, and
    the sampled (bidder, step) lanes' commitments, round-one proofs and
    round-two proofs (each stage's apart)."""
    kept = {"max_bid": int(result.max_bid), "verified": bool(result.verified),
            "deciding": np.asarray(result.deciding_bits)}
    board = result.board
    if board is None:
        return kept
    n = board.commit.phi.shape[0]
    kept["rows"] = n
    if n != len(auction.bids):
        return kept
    dev = board.commit.phi.device
    li = torch.tensor([i for i, _ in lanes], device=dev)
    lj = torch.tensor([j for _, j in lanes], device=dev)
    r1 = _fields(board.round1)
    kept["X"], kept["R"] = r1["X"].clone(), r1["R"].clone()
    kept["b"] = torch.stack([p.b for p in board.round2])
    kept["lanes"] = {k: v[li, lj] for k, v in _fields(board.commit).items()}
    kept["lanes"].update({k: v[lj, li] for k, v in r1.items()
                          if k not in ("X", "R")})
    for stage, attr in ((1, "proof1"), (2, "proof2")):
        steps = [j for j, p in enumerate(board.round2)
                 if getattr(p, attr) is not None]
        mine = [(row, i, j) for row, (i, j) in enumerate(lanes) if j in steps]
        if not mine:
            continue
        pos = torch.tensor([steps.index(j) for _, _, j in mine], device=dev)
        bidders = torch.tensor([i for _, i, _ in mine], device=dev)
        per_step = [_fields(getattr(board.round2[j], attr)) for j in steps]
        kept[f"stage{stage}"] = {
            "rows": [row for row, _, _ in mine],
            **{k: torch.stack([f[k] for f in per_step])[pos, bidders]
               for k in per_step[0]}}
    return kept


def graphs(state: dict) -> list[dict]:
    return [dict(g) for g in state["seal"].last_graphs.values()]


def to_host(kept) -> dict:
    def host(v):
        if isinstance(v, torch.Tensor):
            return v.cpu().numpy()
        if isinstance(v, dict):
            return {k: host(x) for k, x in v.items()}
        return v
    return host(kept)


def check(host, auction, lanes, bases, mix) -> dict:
    return ref.check(host, list(auction.bids), lanes, bases)
