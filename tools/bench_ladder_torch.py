"""Time the port's EC ladders on the card, in isolation from the drivers.

    python tools/bench_ladder_torch.py [--lanes 128 512] [--reps 5]

Counterpart of tools/bench_ladder.py for the PyTorch/CUDA port.  For each
lane count, on random scalars and points from a seed, the mean time per
call (CUDA events around `reps` calls, after one untimed warm-up call) of:

  sm64      ec.scalar_mul_windows: the scalar_mul kernel, 64 windows
  mul_base  ec.mul_base: the comb kernel
  bma64     ec.base_mul_add_windows: the base_mul_add kernel, 64 windows
  glv_sm    ec.scalar_mul: GLV split (plain PyTorch) + dual_mul kernel, 33 windows
  glv_bma   ec.base_mul_add: GLV split (plain PyTorch) + base_mul_add_glv kernel

The GLV rows time the whole call, the split's eager PyTorch kernels
included, as the protocols run it.  Prints one line per lane count and the
card's name and power limit; needs a CUDA device (exits non-zero without).
"""

from __future__ import annotations

import argparse
import pathlib
import random
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

LADDERS = ("sm64", "mul_base", "bma64", "glv_sm", "glv_bma")


def time_ms(fn, reps: int) -> float:
    """Mean ms per call over `reps` calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def bench(lanes_list, reps: int = 5, seed: int = 0,
          device="cuda") -> list[dict]:
    """One row {lanes, sm64, mul_base, bma64, glv_sm, glv_bma} (ms) per lane
    count, on the CUDA `device`."""
    from privacy_auction_tpu_torch.curves import SECP256K1 as C
    from privacy_auction_tpu_torch.ops import ec
    from privacy_auction_tpu_torch.ops import field as F

    dev = torch.device(device)
    rng = random.Random(seed)
    rows = []
    for n in lanes_list:
        def scalars():
            return torch.as_tensor(F.ints_to_limbs(
                [rng.randrange(C.host.n) for _ in range(n)])).to(dev)
        k, t = scalars(), scalars()
        P = ec.mul_base(C, scalars())
        calls = {
            "sm64": lambda: ec.scalar_mul_windows(C, P, k),
            "mul_base": lambda: ec.mul_base(C, k),
            "bma64": lambda: ec.base_mul_add_windows(C, k, P, t),
            "glv_sm": lambda: ec.scalar_mul(C, P, k),
            "glv_bma": lambda: ec.base_mul_add(C, k, P, t),
        }
        row = {"lanes": n}
        row.update({name: time_ms(calls[name], reps) for name in LADDERS})
        rows.append(row)
        print(f"lanes={n}: " + " ".join(f"{name}={row[name]:.3f}ms"
                                        for name in LADDERS), flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, nargs="*", default=[128, 512])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_ladder_torch: no CUDA device available")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    bench(args.lanes, args.reps)


if __name__ == "__main__":
    main()
