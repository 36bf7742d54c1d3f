"""CCS22 through `privacy_auction_tpu_torch.protocols.ccs22.run_auction`,
the fused driver, the evaluator a bidder at a random lane."""

from __future__ import annotations

import numpy as np
import torch

from ..reference import ccs22 as ref

LANE_FIELDS = (("otr1", "T2"), ("otr1", "G"), ("otr1", "H"), ("ots", "z"),
               ("ots", "C0"), ("ots", "C1"))


def prepare(config: dict, mix, device: str) -> dict:
    from privacy_auction_tpu_torch.curves import get_curve
    from privacy_auction_tpu_torch.protocols import ccs22

    curve = get_curve(config["curve"])
    ccs22.pp_or_make(curve, device)          # the public parameters' tables
    return {"ccs22": ccs22, "curve": curve, "c": mix.c, "device": device}


def run(state: dict, auction, phase_times=None):
    return state["ccs22"].run_auction(
        state["curve"], list(auction.bids), state["c"], eval_id=auction.eval_id,
        generator=torch.Generator().manual_seed(auction.nonce_seed),
        device=state["device"], phase_times=phase_times)


def keep(result, auction, lanes):
    """The board's entries the check reads, gathered on the device (the
    rest is freed with the result): the sampled lanes' OT messages, every
    bidder's keys at the sampled steps, the sampled bidders' and the
    evaluator's commitments."""
    board = result.board
    rows = board.setup.X.shape[0]
    kept = {"max_bid": int(result.max_bid),
            "deciding": np.asarray(result.deciding_bits), "rows": rows}
    if rows != len(auction.bids):
        return kept
    dev = board.setup.X.device
    steps = sorted({j for _, j in lanes})
    bidders = sorted({i for i, _ in lanes} | {auction.eval_id})
    li = torch.tensor([i for i, _ in lanes], device=dev)
    lj = torch.tensor([j for _, j in lanes], device=dev)
    kept.update({
        "steps": steps, "com_bidders": bidders,
        "com": board.setup.com.index_select(
            0, torch.tensor(bidders, device=dev)),
        "X_steps": board.setup.X.index_select(
            1, torch.tensor(steps, device=dev)),
        "lanes": {name: getattr(getattr(board, part), name)[lj, li]
                  for part, name in LANE_FIELDS}})
    return kept


def graphs(state: dict) -> list[dict]:
    g = state["ccs22"].last_graph
    return [dict(g)] if g else []


def to_host(kept) -> dict:
    out = dict(kept)
    if "lanes" not in kept:
        return out
    for k in ("com", "X_steps"):
        out[k] = kept[k].cpu().numpy()
    out["lanes"] = {k: v.cpu().numpy() for k, v in kept["lanes"].items()}
    return out


def check(host, auction, lanes, bases, mix) -> dict:
    return ref.check(host, list(auction.bids), mix.c, auction.eval_id,
                     auction.nonce_seed, lanes, bases)
