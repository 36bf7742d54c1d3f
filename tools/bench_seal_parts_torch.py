"""Where the wall clock of the fused SEAL driver goes, at one (n, c).

    python tools/bench_seal_parts_torch.py [n] [c] [--device cuda|cpu]

The port's counterpart of tools/bench_seal_parts.py.  Random bids from a
seed; one verified fused auction cold (on the card: after the kernels'
build is loaded), then a warm one and one without verification, each with
its per-phase times, read from `run_auction(phase_times=...)`: each
phase's wall time after a device synchronize (commit, verify_commit,
round_one, verify_round_one, avnet, b01, steps).  Exit code 0 iff
every run found the plaintext maximum (and verified).
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("n", type=int, nargs="?", default=20)
    ap.add_argument("c", type=int, nargs="?", default=32)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    n, c = args.n, args.c

    import numpy as np
    import torch

    from privacy_auction_tpu_torch.curves import SECP256K1 as C
    from privacy_auction_tpu_torch.protocols import seal

    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("bench_seal_parts_torch: no CUDA device; pass "
                             "--device cpu to run on the CPU")
        from privacy_auction_tpu_torch.ops import cuda_ec

        cuda_ec.build()
    where = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    rng = np.random.default_rng(0)
    bids = [int(x) for x in rng.integers(0, 1 << min(c, 63), size=n)]
    ok = True

    def run(label, verify=True, phase_times=None):
        nonlocal ok
        t0 = time.perf_counter()
        res = seal.run_auction(C, bids, c, verify=verify, device=dev,
                               generator=torch.Generator().manual_seed(42),
                               phase_times=phase_times)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        ok &= res.max_bid == max(bids) and res.verified
        print(f"{label:28s} {ms:9.2f} ms  verified={res.verified} "
              f"max={res.max_bid}", flush=True)

    print(f"# fused SEAL {n}x{c} on {where}")
    run("run_auction (cold)")
    for label, verify in (("warm", True), ("warm, no verify", False)):
        times: dict = {}
        run(f"run_auction ({label})", verify, times)
        for name, s in times.items():
            print(f"  {name:26s} {s * 1e3:9.2f} ms")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
