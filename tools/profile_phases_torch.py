"""Per-phase time of SEAL at one (n, c) on the card, and each phase's
share of a whole auction.

    python tools/profile_phases_torch.py [n] [c] [--device cuda|cpu]
                                         [--reps 3] [--json OUT]
                                         [--profile DIR]

The port's counterpart of tools/profile_phases.py.  It runs each program
of the role-metered SEAL driver on its own from random bids: the commit and
its check once, and the per-step programs at a representative step (round
one, its check, the AV-net keys, round two with its Stage1 proof and with
its Stage2 proof, each proof's check, the round-three veto sum).  Each
time is the best of `reps` calls after one untimed call, on the host clock
around the call and a device synchronize.  It prints each program's ms and
the extrapolated auction: one commit, then c steps, Stage1 at the first
and Stage2 at the other c - 1 (the first step decides for most random
bids), with each phase's share.  --json writes {"n", "c", "device",
"card", "dispatch_s", "extrapolated_total_s", "shares_s"}; --profile DIR
writes a `torch.profiler` Chrome trace of one role-metered auction there.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("n", type=int, nargs="?", default=20)
    ap.add_argument("c", type=int, nargs="?", default=32)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--json", default=None, help="write the times here")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="also trace one role-metered auction into DIR")
    args = ap.parse_args(argv)
    n, c = args.n, args.c

    import numpy as np
    import torch

    from privacy_auction_tpu_torch import cli
    from privacy_auction_tpu_torch.curves import SECP256K1 as C
    from privacy_auction_tpu_torch.protocols import seal
    from privacy_auction_tpu_torch.utils.trackers import TimeTracker

    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("profile_phases_torch: no CUDA device; pass "
                             "--device cpu to run on the CPU")
        from privacy_auction_tpu_torch.ops import cuda_ec

        cuda_ec.build()
    card = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"

    def timed(fn):
        """(best seconds of args.reps calls after an untimed one, output)."""
        out = fn()
        best = float("inf")
        for _ in range(args.reps):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            best = min(best, time.perf_counter() - t0)
        return best, out

    rng = np.random.default_rng(1)
    bids = [int(b) for b in rng.integers(0, 1 << c, n, dtype=np.uint64)]
    bits = torch.as_tensor(seal.bids_to_bits(bids, c), device=dev)
    ids = torch.arange(n, device=dev)
    gen = torch.Generator().manual_seed(0)

    t = {}
    t["commit"], (cpub, csec) = timed(
        lambda: seal.commit(C, gen, bits, ids))
    t["verify_commit"], _ = timed(lambda: seal.verify_commit(C, cpub, ids))
    xr, v = seal.draw_round_one(C, gen, n, 1, dev)
    t["round1"], (pub1, sec1) = timed(
        lambda: seal.round_one_from(C, xr[:, 0], v[:, 0], ids, 0))
    t["verify_round1"], _ = timed(
        lambda: seal.verify_round_one(C, pub1, ids, 0))
    t["avnet"], Y = timed(lambda: seal.avnet_keys(C, pub1.X))
    d = bits[:, 0]
    t["round2_s1"], (pub2, info) = timed(
        lambda: seal.round_two_stage1(C, gen, sec1, pub1, Y, cpub, csec, d,
                                      ids, 0))
    t["verify_round2_s1"], _ = timed(
        lambda: seal.verify_round_two_stage1(C, pub2, pub1, Y, cpub, ids, 0))
    t["round2_s2"], (pub2b, _) = timed(
        lambda: seal.round_two_stage2(C, gen, sec1, pub1, Y, cpub, csec, d,
                                      info, ids, 1))
    t["verify_round2_s2"], _ = timed(
        lambda: seal.verify_round_two_stage2(C, pub2b, pub1, Y, cpub, info,
                                             ids, 1))
    t["round3"], _ = timed(lambda: seal.round_three(C, pub2.b))

    step = t["round1"] + t["verify_round1"] + t["avnet"] + t["round3"]
    total = (t["commit"] + t["verify_commit"]
             + step + t["round2_s1"] + t["verify_round2_s1"]
             + (c - 1) * (step + t["round2_s2"] + t["verify_round2_s2"]))
    shares = {
        "commit": t["commit"] + t["verify_commit"],
        "round1": c * (t["round1"] + t["verify_round1"]),
        "avnet": c * t["avnet"],
        "round2_gen": t["round2_s1"] + (c - 1) * t["round2_s2"],
        "round2_verify": t["verify_round2_s1"] + (c - 1) * t["verify_round2_s2"],
        "round3": c * t["round3"],
    }
    print(f"# SEAL {n}x{c} time a program on {card} (best of {args.reps})")
    for k, s in t.items():
        print(f"{k:20s} {s * 1e3:10.2f} ms a call")
    print(f"# extrapolated auction: {total:.3f} s; phase shares:")
    for k, s in sorted(shares.items(), key=lambda kv: -kv[1]):
        print(f"{k:20s} {s:10.3f} s  {100 * s / total:5.1f}%")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"n": n, "c": c, "device": str(dev), "card": card,
                       "dispatch_s": t, "extrapolated_total_s": total,
                       "shares_s": shares}, f, indent=1)
    if args.profile:
        with cli._maybe_profile(args.profile, f"profile_phases_{n}x{c}"):
            res = seal.run_auction(C, bids, c, verify=True,
                                   generator=torch.Generator().manual_seed(9),
                                   device=dev, times=TimeTracker())
        print(f"# traced one role-metered auction: max_bid={res.max_bid}, "
              f"verified={res.verified}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
