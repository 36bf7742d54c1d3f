"""graph_setup_s: the step graphs' set-up an auction, warm-up step,
capture and instantiation summed over the graphs it captured
(`seal.last_graphs`, `ccs22.last_graph`), the mean over the unprofiled
auctions."""

from auction_bench.metrics._records import unprofiled


def read(records: dict):
    runs = [a["graphs"] for a in unprofiled(records) if a["graphs"]]
    if not runs:
        return None
    return sum(sum(g["warmup_s"] + g["capture_s"] + g["instantiate_s"]
                   for g in gs) for gs in runs) / len(runs)
