"""Command-line driver of the PyTorch port:

    python -m privacy_auction_tpu_torch.cli seal <n> <c> [--seed S] [--no-verify]
        [--fast] [--cold] [--profile DIR] [--device cuda|cpu]
    python -m privacy_auction_tpu_torch.cli ccs22 <n> <c> [--seed S]
        [--fast] [--cold] [--profile DIR] [--device cuda|cpu]

Random bids from the seed (and, for CCS22, a random evaluator), one auction
on the device (the GPU by default), and the report of
`privacy_auction_tpu/cli.py`: time and data per bidder and per verifier
(per evaluator for CCS22), total data, per-phase wall times and the wall
clock.  The role-metered driver runs by default; `--fast` runs the fused
driver, which reports data and phase times but no time per role.  Exit
codes: 0 when the auction's max bid equals the plaintext maximum (and, for
SEAL with verification, every NIZK verified), 1 otherwise; 2 for bad
arguments (argparse).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np

from .utils import log

WARMUP_N, WARMUP_C = 3, 2


@contextlib.contextmanager
def _maybe_profile(profile_dir, name: str):
    """A `torch.profiler` trace of the block (CPU, and CUDA when there is
    a card), exported as a Chrome trace `<name>.json` into profile_dir."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"{name}.json")
    prof.export_chrome_trace(path)
    log.info(f"profiler trace written to {path}")


def _warm_up(device: str, auction):
    """Untimed: the CUDA kernels' build (nvcc on a card's first run, or
    loading an earlier build) and one auction at WARMUP_N x WARMUP_C, so
    that the report measures the protocol, as the reference's do."""
    if device != "cpu":
        from .ops import cuda_ec

        cuda_ec.build()
    auction()


def _report_phases(tag: str, phase_times: dict, wall: float):
    for name, sec in phase_times.items():
        log.message(f"[{tag}] phase {name}: {sec:.6f} s")
    log.message(f"[{tag}] wall-clock: {wall:.3f} s")


def seal_report(n: int, c: int, device: str, times, data, phase_times: dict,
                wall: float):
    """The report of `SEAL/main.cpp:128-149`, from a `TimeTracker` (None:
    no time per role) and a `DataTracker`.  One batched prover call serves
    all n bidders (one bidder's share is the total / n); one batched check
    verifies each proof once, one reference verifier's work, so it is not
    divided."""
    from .utils import trackers as T

    log.message(f"[SEAL] #bidders: n = {n}, bit length of bids: c = {c}, "
                f"device: {device}")
    if times is not None:
        log.message(
            f"[SEAL] Time (one bidder): "
            f"{times.get_category_time_seconds(T.CATEGORY_BIDDER) / n:.6f} s.")
        log.message(
            f"[SEAL] Time (one verifier): "
            f"{times.get_category_time_seconds(T.CATEGORY_VERIFIER):.6f} s.")
    log.message(f"[SEAL] Data (one bidder): "
                f"{data.get_category_data_mb(T.CATEGORY_BIDDER) / n:.6f} MB")
    log.message(f"[SEAL] Data (one verifier): "
                f"{data.get_category_data_mb(T.CATEGORY_VERIFIER) / n:.6f} MB")
    log.message(f"[SEAL] Data (total communication, #bidders={n}, "
                f"#verifiers={n}): {data.get_total_data_mb():.6f} MB")
    _report_phases("SEAL", phase_times, wall)


def ccs22_report(n: int, c: int, eval_id: int, device: str, times, data,
                 phase_times: dict, wall: float):
    """The report of `CCS22/main.cpp:140-167`: n-1 common bidders, one
    evaluator, and the shared category (the CRS download) split per
    party."""
    from .utils import trackers as T

    shared_mb = data.get_category_data_mb(T.CATEGORY_BIDDER_AND_EVALUATOR)
    bidders = max(n - 1, 1)
    log.message(f"[CCS22] #bidders: n = {n}, bit length of bids: c = {c}, "
                f"evaluator: {eval_id}, device: {device}")
    if times is not None:
        log.message(
            f"[CCS22] Time (one bidder): "
            f"{times.get_category_time_seconds(T.CATEGORY_BIDDER) / bidders:.6f}"
            " s.")
        log.message(
            f"[CCS22] Time (one evaluator): "
            f"{times.get_category_time_seconds(T.CATEGORY_EVALUATOR):.6f} s.")
    log.message(
        f"[CCS22] Data (one bidder): "
        f"{data.get_category_data_mb(T.CATEGORY_BIDDER) / bidders + shared_mb / n:.6f}"
        " MB")
    log.message(
        f"[CCS22] Data (one evaluator): "
        f"{data.get_category_data_mb(T.CATEGORY_EVALUATOR) + shared_mb / n:.6f}"
        " MB")
    log.message(f"[CCS22] Data (total communication, #bidders={n - 1}, "
                f"#evaluators=1): {data.get_total_data_mb():.6f} MB")
    _report_phases("CCS22", phase_times, wall)


def run_seal(n: int, c: int, seed: int, verify: bool, device: str = "cuda",
             warmup: bool = True, profile_dir: str | None = None,
             fast: bool = False) -> int:
    import torch

    from .curves import SECP256K1 as CURVE
    from .protocols import seal
    from .utils import trackers as T

    rng = np.random.default_rng(seed)
    bids = [int(b) for b in rng.integers(0, 1 << c, n)]
    data = T.DataTracker()
    times = None if fast else T.TimeTracker()
    phase_times = {}

    if warmup:
        _warm_up(device, lambda: seal.run_auction(
            CURVE, [1, 0, 1][:WARMUP_N], WARMUP_C, verify=verify,
            generator=torch.Generator().manual_seed(seed + 1), device=device,
            times=None if fast else T.TimeTracker()))
    t0 = time.perf_counter()
    with _maybe_profile(profile_dir, f"seal_{n}x{c}"):
        res = seal.run_auction(CURVE, bids, c, verify=verify,
                               generator=torch.Generator().manual_seed(seed),
                               device=device, phase_times=phase_times,
                               times=times, trackers=T.SealCommTracker(data))
    wall = time.perf_counter() - t0

    seal_report(n, c, device, times, data, phase_times, wall)
    if verify and not res.verified:
        log.error("[SEAL] NIZK verification failed")
        return 1
    if res.max_bid != max(bids):
        log.error(f"[SEAL] maxBid {res.max_bid} != {max(bids)}")
        return 1
    log.message(f"[SEAL] OK: maxBid = {res.max_bid}")
    return 0


def run_ccs22(n: int, c: int, seed: int, device: str = "cuda",
              warmup: bool = True, profile_dir: str | None = None,
              fast: bool = False) -> int:
    import torch

    from .curves import SECP256K1 as CURVE
    from .protocols import ccs22
    from .utils import trackers as T

    rng = np.random.default_rng(seed)
    bids = [int(b) for b in rng.integers(0, 1 << c, n)]
    eval_id = int(rng.integers(0, n))      # a random evaluator
    data = T.DataTracker()
    comm = T.Ccs22CommTracker(data)
    comm.account_setup(n, c)
    times = None if fast else T.TimeTracker()
    phase_times = {}

    if warmup:
        _warm_up(device, lambda: ccs22.run_auction(
            CURVE, [1, 0, 1][:WARMUP_N], WARMUP_C, 0,
            generator=torch.Generator().manual_seed(seed + 1), device=device,
            times=None if fast else T.TimeTracker()))
    t0 = time.perf_counter()
    with _maybe_profile(profile_dir, f"ccs22_{n}x{c}"):
        res = ccs22.run_auction(CURVE, bids, c, eval_id,
                                generator=torch.Generator().manual_seed(seed),
                                device=device, phase_times=phase_times,
                                times=times, trackers=comm)
    wall = time.perf_counter() - t0

    ccs22_report(n, c, eval_id, device, times, data, phase_times, wall)
    if res.max_bid != max(bids):
        log.error(f"[CCS22] maxBid {res.max_bid} != {max(bids)}")
        return 1
    log.message(f"[CCS22] OK: maxBid = {res.max_bid} (evaluator {eval_id})")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="privacy_auction_tpu_torch")
    sub = ap.add_subparsers(dest="protocol", required=True)
    for name in ("seal", "ccs22"):
        p = sub.add_parser(name)
        p.add_argument("n", type=int, help="number of bidders")
        p.add_argument("c", type=int, help="bid bit-length")
        p.add_argument("--seed", type=int, default=None)
        p.add_argument("--fast", action="store_true",
                       help="run the fused driver (no time per role)")
        p.add_argument("--cold", action="store_true",
                       help="skip the untimed warm-up (the CUDA kernels' "
                            f"build and a {WARMUP_N}x{WARMUP_C} auction); "
                            "the report then includes the build, nvcc's "
                            "compile on a card's first run")
        p.add_argument("--profile", metavar="DIR", default=None,
                       help="write a torch.profiler Chrome trace of the "
                            "reported run into DIR")
        if name == "seal":
            p.add_argument("--no-verify", action="store_true",
                           help="disable NIZK verification "
                                "(ENABLE_VERIFICATION off)")
        p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    seed = args.seed if args.seed is not None else int(time.time()) & 0xFFFF
    opts = dict(device=args.device, warmup=not args.cold,
                profile_dir=args.profile, fast=args.fast)
    if args.protocol == "seal":
        return run_seal(args.n, args.c, seed, not args.no_verify, **opts)
    return run_ccs22(args.n, args.c, seed, **opts)


if __name__ == "__main__":
    sys.exit(main())
