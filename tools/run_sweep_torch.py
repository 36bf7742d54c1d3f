"""The reference-parity randomized sweep (the ctest equivalent) through the
port's drivers.

    python tools/gen_tests.py --tests 100 --bidders_max 20 --bitslen_max 32 \
        --out params.txt --seed 5
    python tools/run_sweep_torch.py [--params params.txt] [--seed 0]
                                    [--seal-only | --ccs22-only]
                                    [--device cuda|cpu]

The port's counterpart of tools/run_sweep.py.  The reference's whole test
modality is ctest over about 100 random (n, c) pairs, n in [1, 20], c in
[1, 32], pass = exit code 0.  For every pair of the params file this runs
a verified SEAL auction and a CCS22 auction with a random evaluator, each
at the pair's own n and c, with the bids and evaluator the JAX sweep draws
for the pair, and checks every maximum against the plaintext one.  (The
JAX sweep pads pairs into a few shape buckets to bound XLA compiles; the
port compiles nothing per shape.)  Exit code 0 iff every pair passed.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--params", default="params.txt",
                    help="params.txt from tools/gen_tests.py")
    ap.add_argument("--seal-only", action="store_true")
    ap.add_argument("--ccs22-only", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    path = pathlib.Path(args.params)
    if not path.exists():
        print(f"params file {path} not found; run tools/gen_tests.py first",
              file=sys.stderr)
        return 2
    pairs = [tuple(map(int, ln.split()))
             for ln in path.read_text().splitlines() if ln.strip()]

    import numpy as np
    import torch

    from privacy_auction_tpu_torch.curves import SECP256K1 as C
    from privacy_auction_tpu_torch.protocols import ccs22, seal

    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("run_sweep_torch: no CUDA device; pass --device "
                             "cpu to run on the CPU")
        from privacy_auction_tpu_torch.ops import cuda_ec

        cuda_ec.build()
    where = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    print(f"# reference-parity sweep: {len(pairs)} pairs on {where}",
          flush=True)
    t_all = time.perf_counter()
    failures = 0
    for i, (n, c) in enumerate(pairs):
        rng = np.random.default_rng(args.seed * 1_000_003 + n * 1000 + c)
        bids = [int(b) for b in rng.integers(0, 1 << c, n)]
        want = max(bids)
        line = f"[{i + 1:3d}/{len(pairs)}] n={n:2d} c={c:2d}"
        ok = True
        if not args.ccs22_only:
            t0 = time.perf_counter()
            res = seal.run_auction(
                C, bids, c, verify=True, device=dev,
                generator=torch.Generator().manual_seed(n * 77 + c))
            good = res.verified and res.max_bid == want
            ok &= good
            line += (f"  SEAL {'ok' if good else 'FAIL'} max={res.max_bid} "
                     f"{time.perf_counter() - t0:6.2f}s")
        if not args.seal_only:
            eval_id = int(rng.integers(0, n))
            t0 = time.perf_counter()
            res = ccs22.run_auction(
                C, bids, c, eval_id, device=dev,
                generator=torch.Generator().manual_seed(n * 99 + c))
            good = res.max_bid == want
            ok &= good
            line += (f"  CCS22 {'ok' if good else 'FAIL'} max={res.max_bid} "
                     f"{time.perf_counter() - t0:6.2f}s")
        failures += not ok
        print(line, flush=True)
    verdict = "PASS" if failures == 0 else f"FAIL ({failures} pairs)"
    print(f"# {verdict}: {len(pairs) - failures}/{len(pairs)} pairs in "
          f"{time.perf_counter() - t_all:.1f}s on {where}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
