"""replay_ms: a step graph's replay, host clock (SEAL: with its deciding
flag's read; CCS22: the replays to the synchronize after the last), the
graphs' replay seconds over their replays, over the unprofiled auctions."""

from auction_bench.metrics._records import unprofiled


def read(records: dict):
    graphs = [g for a in unprofiled(records) for g in a["graphs"]]
    replays = sum(g["replays"] for g in graphs)
    if not replays:
        return None
    return 1e3 * sum(g["replay_s"] for g in graphs) / replays
