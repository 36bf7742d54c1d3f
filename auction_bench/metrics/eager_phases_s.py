"""eager_phases_s: the protocol driver's phases outside the steps (every
`phase_times` entry but "steps", each timed to a device synchronize), summed
an auction, the mean over the unprofiled auctions of a traced run."""

from auction_bench.metrics._records import unprofiled


def read(records: dict):
    runs = [a["phase_s"] for a in unprofiled(records) if a["phase_s"]]
    if not runs:
        return None
    return sum(sum(v for k, v in p.items() if k != "steps")
               for p in runs) / len(runs)
