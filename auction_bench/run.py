"""Run one cell of the benchmark once, on one H100:

    python -m auction_bench.run --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (`BENCHMARK.json` `workloads`)
names a configuration (`auction_bench/configs/<file>`, its `protocol`
picking `auction_bench/drivers/<protocol>.py`) and a traffic mix
(`auction_bench/traffic/<traffic>.json`); each metric the cell reports is
read by `auction_bench/metrics/<metric>.py` from the run's records.

Set-up (`setup_s`): imports, the CUDA context, the kernels' build (loaded
from `build/cuda_ec/` of the checkout, built there by the first run), what
the protocol driver's `prepare` loads, and one warm-up auction at the
cell's shape from a seed apart from the window's.  The window: whole auctions back to
back, one client, each a call of the program's fused `run_auction` timed
by the host clock from the call to its result, until `--seconds` have
passed and the last auction has finished.  With `--trace 1` every auction
also times its phases (`phase_times`, a device synchronize each), and the
profiler covers the traffic's `profile_auctions` auctions after the first.

Once the window has closed: the peak of device memory is read, the boards
are copied to the host and the device freed, the process is checked for
JAX, and the plain reference (`auction_bench/reference/`) judges every
auction's outcome and its board at the sampled lanes.  The last line of
standard output is the result as one JSON object; the numbers compared,
each beside its limit, are the last lines of standard error and the last
key of the result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / "build" / "auction_bench"
# every compile cache inside the checkout, at a fixed path
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)

FORBIDDEN = ("jax", "jaxlib", "flax", "privacy_auction_tpu")
# the numbers compared and their limits: exact comparisons
LIMITS = {"outcome_mismatches": 0, "board_mismatches": 0}


class Cell:
    """A workload of the manifest with its configuration, traffic mix and
    metrics."""

    def __init__(self, workload: str, root: pathlib.Path = ROOT):
        from .traffic import Mix

        manifest = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in manifest["workloads"]}
        if workload not in cells:
            raise SystemExit(f"auction_bench: no workload {workload!r}")
        self.workload = cells[workload]
        entry = {c["name"]: c for c in manifest["configs"]}[
            self.workload["config"]]
        self.config = json.loads((root / entry["file"]).read_text())
        traffic = self.workload["traffic"]
        self.mix = Mix.from_dict(traffic, json.loads(
            (root / HERE.name / "traffic" / f"{traffic}.json").read_text()))
        self.root = root
        self.chips = int(self.workload["chips"])

        def reported(m):
            return workload in m.get("workloads", [workload])

        self.end_to_end = [m for m in manifest["end_to_end"] if reported(m)]
        self.per_layer = [m for m in manifest["per_layer"] if reported(m)]
        self.driver = importlib.import_module(
            f"auction_bench.drivers.{self.config['protocol']}")


def load_metric(name: str, root: pathlib.Path = ROOT):
    """`metrics/<name>.py`'s `read(records)`."""
    spec = importlib.util.spec_from_file_location(
        f"auction_bench.metrics.{name}",
        root / HERE.name / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def window(cell: Cell, state, seed: int, seconds: float, trace: bool,
           device: str) -> tuple[dict, list]:
    """Auctions back to back until `seconds` have passed; returns the
    records and, per auction, (auction, lanes, what the check reads)."""
    import torch
    from torch.profiler import record_function

    from . import traffic as T

    drv, mix = cell.driver, cell.mix
    ec = _cuda_ec() if device == "cuda" else None
    profiled = range(1, 1 + mix.profile_auctions) if trace else range(0)
    auctions, kept = [], []
    prof = profile = launches_before = None
    paused = 0.0
    t_start = time.perf_counter()
    i = 0
    while True:
        a = T.auction(mix, seed, i)
        lanes = T.sample_lanes(mix, a)
        if i in profiled and i == profiled.start:
            launches_before = dict(ec.launch_lanes) if ec else {}
            prof = _profiler()
            prof.__enter__()
        phase_s = {} if trace else None
        t0 = time.perf_counter()
        if trace:
            with record_function("auction_bench.auction"):
                result = drv.run(state, a, phase_s)
        else:
            result = drv.run(state, a, phase_s)
        t1 = time.perf_counter()
        kept.append((a, lanes, drv.keep(result, a, lanes)))
        del result
        graphs = drv.graphs(state)
        auctions.append({"wall_s": t1 - t0, "phase_s": phase_s,
                         "graphs": graphs, "profiled": i in profiled})
        i += 1
        if prof is not None and i == profiled.stop:
            torch.cuda.synchronize()
            t_pause = time.perf_counter()
            prof.__exit__(None, None, None)
            profile = _read_profile(prof, ec, launches_before, auctions)
            prof = None
            paused += time.perf_counter() - t_pause
        if t1 - t_start - paused >= seconds and i >= profiled.stop:
            break
    records = {"window_s": t1 - t_start - paused, "auctions": auctions,
               "profile": profile}
    if device == "cuda":
        records["peak_bytes"] = torch.cuda.max_memory_allocated()
        records["sms"] = torch.cuda.get_device_properties(
            0).multi_processor_count
    return records, kept


def _cuda_ec():
    from privacy_auction_tpu_torch.ops import cuda_ec

    return cuda_ec


def _profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _read_profile(prof, ec, launches_before: dict, auctions: list) -> dict:
    """The profiled auctions' device sums (`trace.summarize`) with the EC
    and SHA-256 launches the program counted in them: its counters' growth,
    and each graph's warm-up step, which runs its captured launches once
    uncounted."""
    from . import trace

    summary = trace.summarize(prof.profiler.kineto_results.events())
    if summary is None:
        return None
    launches = {}
    for key, v in ec.launch_lanes.items():
        if v != launches_before.get(key, 0):
            launches[key] = v - launches_before.get(key, 0)
    for rec in auctions:
        if rec["profiled"]:
            for g in rec["graphs"]:
                for key, v in g["launches"].items():
                    launches[key] = launches.get(key, 0) + v
    summary["launches"] = launches
    summary["auctions"] = sum(1 for r in auctions if r["profiled"])
    return summary


def judge(cell: Cell, kept: list) -> dict:
    """The plain reference's verdict on every auction of the window."""
    from .reference import secp256k1

    bases = secp256k1.Bases()
    outcome = board = failed = 0
    notes = []
    for a, lanes, k in kept:
        bad = cell.driver.check(k, a, lanes, bases, cell.mix)
        outcome += bool(bad["outcome"])
        board += len(bad["board"])
        failed += bool(bad["outcome"] or bad["board"])
        notes += [f"auction {a.index}: {w}"
                  for w in bad["outcome"] + bad["board"]][:5]
    return {"outcome_mismatches": outcome, "board_mismatches": board,
            "failed": failed, "notes": notes}


def jax_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_begin: float = T0) -> dict:
    """One run: set-up, the window, the check.  Returns the result object
    (without the JAX check, which `main` makes)."""
    import torch

    state = cell.driver.prepare(cell.config, cell.mix, device)
    from . import traffic as T

    warm = T.auction(cell.mix, seed, 0, T.WARMUP)
    cell.driver.run(state, warm)
    if device == "cuda":
        torch.cuda.synchronize()
        if trace:           # the profiler's own start-up, once, in set-up
            with _profiler():
                torch.ones(1, device=device).add_(1)
            torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_begin

    records, kept = window(cell, state, seed, seconds, trace, device)
    records["setup_s"] = setup_s
    t_closed = time.perf_counter()
    kept = [(a, lanes, cell.driver.to_host(k)) for a, lanes, k in kept]
    del state
    if device == "cuda":
        torch.cuda.empty_cache()
    t_host = time.perf_counter()
    verdict = judge(cell, kept)
    t_judged = time.perf_counter()

    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = load_metric(m["name"], cell.root)(records)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": all(verdict[k] <= v for k, v in LIMITS.items()),
              "attempted": len(kept), "failed": verdict["failed"],
              "metrics": metrics, "device": _device(records, cell, trace)}
    if trace and records.get("profile"):
        p = records["profile"]
        result["breakdown"] = {"device_ops": p["device_ops"],
                               "idle_gaps": p["idle_gaps"]}
        result["_traced"] = _traced_counts(p)
    result["checks"] = {k: {"value": verdict[k], "limit": v}
                        for k, v in LIMITS.items()}
    walls = " ".join(f"{a['wall_s']:.4f}" for a in records["auctions"])
    result["_notes"] = verdict["notes"] + [
        f"setup {setup_s:.3f} s, window {records['window_s']:.3f} s, "
        f"boards to host {t_host - t_closed:.3f} s, reference "
        f"{t_judged - t_host:.3f} s; auctions (s): {walls}"]
    return result


def _traced_counts(p: dict) -> str:
    """The profiler's count of the port's kernels beside the program's
    launch counters for the same auctions (the profiler can drop
    records)."""
    counted = {"ec": 0, "sha256": 0}
    for (row, _), v in p["launches"].items():
        counted["sha256" if row == "sha256" else "ec"] += v
    return (f"EC kernels traced {p['ec_kernel_count']} counted "
            f"{counted['ec']} (difference "
            f"{p['ec_kernel_count'] - counted['ec']}); sha256 traced "
            f"{p['sha256_kernel_count']} counted {counted['sha256']} "
            f"(difference {p['sha256_kernel_count'] - counted['sha256']})")


def _device(records: dict, cell: Cell, trace: bool) -> dict:
    import torch

    if not torch.cuda.is_available():
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": cell.chips, "memory_peak_bytes": records["peak_bytes"]}
    if trace and records.get("profile"):
        out["busy_s"] = records["profile"]["busy_s"]
        out["window_s"] = records["profile"]["window_s"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(args.workload)

    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"auction_bench: the cell needs {cell.chips} CUDA device(s), "
              f"found {found}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = jax_modules()
    if found:
        print(f"auction_bench: the process loaded {found}", file=sys.stderr)
        return 3
    if result["device"].get("busy_s") == 0:
        print("auction_bench: the traced window shows no device operation",
              file=sys.stderr)
        return 4
    for note in result.pop("_notes"):
        print(f"run: {note}", file=sys.stderr)
    if result.get("_traced"):
        print(f"profile: {result.pop('_traced')}", file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"{k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
