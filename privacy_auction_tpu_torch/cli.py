"""Command-line driver of the PyTorch port:

    python -m privacy_auction_tpu_torch.cli seal <n> <c> [--seed S] [--no-verify]
                                                [--device cuda|cpu]
    python -m privacy_auction_tpu_torch.cli ccs22 <n> <c> [--seed S]
                                                 [--device cuda|cpu]

Random bids from the seed (and, for CCS22, a random evaluator), one auction
on the device (the GPU by default), per-phase wall times, and the exit-code
contract of `privacy_auction_tpu/cli.py`: 0 when the auction's max bid
equals the plaintext maximum (and, for SEAL with verification, every NIZK
verified), 1 otherwise; 2 for bad arguments (argparse).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .utils import log


def run_seal(n: int, c: int, seed: int, verify: bool, device: str) -> int:
    import torch

    from .curves import SECP256K1 as CURVE
    from .protocols import seal

    rng = np.random.default_rng(seed)
    bids = [int(b) for b in rng.integers(0, 1 << c, n)]
    times = {}
    t0 = time.perf_counter()
    res = seal.run_auction(CURVE, bids, c, verify=verify,
                           generator=torch.Generator().manual_seed(seed),
                           device=device, times=times)
    wall = time.perf_counter() - t0
    log.message(f"[SEAL] #bidders: n = {n}, bit length of bids: c = {c}, "
                f"device: {device}")
    for name, sec in times.items():
        log.message(f"[SEAL] phase {name}: {sec:.6f} s")
    log.message(f"[SEAL] wall-clock: {wall:.3f} s")
    if verify and not res.verified:
        log.error("[SEAL] NIZK verification failed")
        return 1
    if res.max_bid != max(bids):
        log.error(f"[SEAL] maxBid {res.max_bid} != {max(bids)}")
        return 1
    log.message(f"[SEAL] OK: maxBid = {res.max_bid}")
    return 0


def run_ccs22(n: int, c: int, seed: int, device: str) -> int:
    import torch

    from .curves import SECP256K1 as CURVE
    from .protocols import ccs22

    rng = np.random.default_rng(seed)
    bids = [int(b) for b in rng.integers(0, 1 << c, n)]
    eval_id = int(rng.integers(0, n))      # a random evaluator
    times = {}
    t0 = time.perf_counter()
    res = ccs22.run_auction(CURVE, bids, c, eval_id,
                            generator=torch.Generator().manual_seed(seed),
                            device=device, times=times)
    wall = time.perf_counter() - t0
    log.message(f"[CCS22] #bidders: n = {n}, bit length of bids: c = {c}, "
                f"evaluator: {eval_id}, device: {device}")
    for name, sec in times.items():
        log.message(f"[CCS22] phase {name}: {sec:.6f} s")
    log.message(f"[CCS22] wall-clock: {wall:.3f} s")
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
        if name == "seal":
            p.add_argument("--no-verify", action="store_true",
                           help="disable NIZK verification "
                                "(ENABLE_VERIFICATION off)")
        p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    seed = args.seed if args.seed is not None else int(time.time()) & 0xFFFF
    if args.protocol == "seal":
        return run_seal(args.n, args.c, seed, not args.no_verify, args.device)
    return run_ccs22(args.n, args.c, seed, args.device)


if __name__ == "__main__":
    sys.exit(main())
