"""The control and the faults of a cell, run on the card at the cell's own
size: each seed's run under a fault planted in the timed path
(`faults.py`) has to come out not correct.  The benchmark's own runs never
run this.

    python -m auction_bench.control --workload <name> --seconds <s> \
        --faults altered_hash stale_state half_batch --seeds <n> <n> <n>

One process: one set-up (and its warm-up auction) a fault and seed, a
short window, the check; one JSON line a run with the numbers compared
and `correct`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import faults
from . import run as R


def control_runs(cell, fault_names, seeds, seconds: float, device: str):
    for fault in fault_names:
        for seed in seeds:
            with faults.planted(fault, cell.config["protocol"]):
                result = R.run_cell(cell, seed, seconds, False, device,
                                    time.perf_counter())
            yield {"fault": fault, "seed": seed, "correct": result["correct"],
                   "attempted": result["attempted"],
                   "failed": result["failed"],
                   "checks": {k: v["value"]
                              for k, v in result["checks"].items()},
                   "notes": result["_notes"][:3]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--faults", nargs="+", default=list(faults.FAULTS))
    ap.add_argument("--seeds", nargs="+", type=int, required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("auction_bench.control: needs a CUDA device", file=sys.stderr)
        return 2
    cell = R.Cell(args.workload)
    caught = True
    for line in control_runs(cell, args.faults, args.seeds, args.seconds,
                             "cuda"):
        caught &= not line["correct"]
        print(json.dumps(line), flush=True)
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
