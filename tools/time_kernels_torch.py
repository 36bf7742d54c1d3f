"""Time each CUDA kernel of a checkout of the port on the card, alone.

    python tools/time_kernels_torch.py [--root DIR] [--reps 10] [--seed 0]
                                       [--groups LANES ...]
                                       [--comb WARPS:RING ...]

Loads `privacy_auction_tpu_torch` from the checkout at DIR (this one by
default), so that two commits can be timed on one card in one call: run it
on each checkout in turns (A, B, B, A).  For each kernel row at the lane
counts the auctions launch it at (SHAPES), on random points and scalars
from the seed: the mean ms per launch (CUDA events around `reps` launches
after one untimed launch).

With --groups (this checkout's kernels only): the six group kernels at
each of LANES with each G they are built for (`cuda_ec.GROUPS`: 8 and 4
threads a lane, 8 and 2 for mul_comb), in turns (8 4 4 8), whatever
`cuda_ec.launch_shape` would pick, under "groups": {"kernel@lanes": {"8":
[ms, ms], "4": [ms, ms], ...}}.  With --comb as well, mul_comb at each of
LANES in each block shape WARPS:RING (warps a block, window tables in the
block's ring; RING 64 holds the whole comb table) with each G, in turns
(shapes in order, then reversed), under "comb": {"mul_comb@lanes": {"G
warps:ring": [ms, ms]}}.

Prints the card's name and power limit and one JSON line {"root", "card",
"ms": {"row@lanes": ms}, ...}; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import random
import subprocess
import sys

# The 128x32 SEAL auction's shape of each row (dual_mul's for the kernels
# only the validator reaches), then the other lane counts of the auctions:
# mul_comb at SEAL 20x32 (commit 5nc, round one 4nc) and 128x32 (5nc), and
# at CCS22 20x32 and 64x32 (n, nc, 4nc); dual_mul at SEAL 20x32 (2nc) and
# CCS22 64x32 (2nc); quad_mul's 20x32 proof and commit passes;
# base_mul_add_glv's 20x32 round-one check.  scalar_mul and base_mul_add
# (8,192 lanes, and the validator's 8) come last, so that a change to
# them leaves the launches before every other row as they were.
SHAPES = (("mul_comb", 16384), ("dual_mul", 8192), ("quad_mul", 2048),
          ("base_mul_add_glv", 8192), ("dual_mul_64", 8192), ("pt_add", 8192),
          ("mul_comb", 20), ("mul_comb", 64), ("mul_comb", 640),
          ("mul_comb", 2048), ("mul_comb", 2560), ("mul_comb", 3200),
          ("mul_comb", 8192), ("mul_comb", 20480),
          ("dual_mul", 1280), ("dual_mul", 4096),
          ("quad_mul", 160), ("quad_mul", 320), ("quad_mul", 2560),
          ("quad_mul", 3840), ("base_mul_add_glv", 1280),
          ("scalar_mul", 8192), ("base_mul_add", 8192), ("scalar_mul", 8),
          ("base_mul_add", 8))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--groups", type=int, nargs="*", default=[])
    ap.add_argument("--comb", nargs="*", default=[])
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_kernels_torch: no CUDA device")
    from privacy_auction_tpu_torch.curves import (COMB_WINDOWS, GLV_WINDOWS,
                                                  SECP256K1 as C)
    from privacy_auction_tpu_torch.ops import cuda_ec, ec
    from privacy_auction_tpu_torch.ops import field as F

    dev = torch.device("cuda", 0)
    rng = random.Random(args.seed)

    def scalars(n, bits=256):
        ks = [rng.randrange(1 << bits) % C.host.n for _ in range(n)]
        return torch.as_tensor(F.ints_to_limbs(ks)).to(dev)

    def points(n):
        return ec.mul_base(C, scalars(n))

    def call(name, n, **shape):
        """A launch of row `name` over n lanes; `shape` (the group kernels'
        launch shape) only where given, so that older checkouts run too."""
        if name == "mul_comb":
            table, k = C.tensor("comb_table", dev), scalars(n)
            return lambda: cuda_ec.mul_comb(table, k, **shape)
        if name == "pt_add":
            P, Q = points(n), points(n)
            return lambda: cuda_ec.pt_add(P, Q)
        if name == "scalar_mul":
            P, k = points(n), scalars(n)
            return lambda: cuda_ec.scalar_mul(P, k, **shape)
        if name == "dual_mul_64":
            a = [points(n), scalars(n), points(n), scalars(n)]
            return lambda: cuda_ec.dual_mul(*a, COMB_WINDOWS)
        if name == "base_mul_add":
            s, P, t, g0 = scalars(n), points(n), scalars(n), C.tensor("g0_table", dev)
            return lambda: cuda_ec.base_mul_add(s, P, t, g0, **shape)
        srcs = {"dual_mul": 2, "quad_mul": 4, "base_mul_add_glv": 2}[name]
        a = [t for _ in range(srcs) for t in (points(n), scalars(n, 132))]
        if name == "dual_mul":
            return lambda: cuda_ec.dual_mul(*a, GLV_WINDOWS, **shape)
        if name == "quad_mul":
            return lambda: cuda_ec.quad_mul(*a, GLV_WINDOWS, **shape)
        s1, s2 = scalars(n, 132), scalars(n, 132)
        flags = torch.randint(0, 2, (n, 2), device=dev)
        g0 = C.tensor("g0_tables", dev)
        return lambda: cuda_ec.base_mul_add_glv(*a, s1, s2, flags, g0,
                                                GLV_WINDOWS, **shape)

    def time_ms(fn):
        fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(args.reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / args.reps

    cuda_ec.build()
    out = {f"{name}@{n}": time_ms(call(name, n)) for name, n in SHAPES}
    groups = {}
    for n in args.groups:
        for name in cuda_ec.GROUP_KERNELS:
            gs = cuda_ec.GROUPS[name]
            runs = {g: call(name, n, shape=cuda_ec.launch_shape(name, n, group=g))
                    for g in gs}
            ms = {g: [] for g in gs}
            for g in gs + gs[::-1]:
                ms[g].append(time_ms(runs[g]))
            groups[f"{name}@{n}"] = ms
    comb = {}
    variants = [(g, *map(int, v.split(":"))) for v in args.comb
                for g in cuda_ec.GROUPS["mul_comb"]]
    for n in args.groups if variants else ():
        runs = {v: call("mul_comb", n, shape=cuda_ec.comb_shape(n, *v))
                for v in variants}
        ms = {f"{g} {w}:{r}": [] for g, w, r in variants}
        for v in variants + variants[::-1]:
            ms["{} {}:{}".format(*v)].append(time_ms(runs[v]))
        comb[f"mul_comb@{n}"] = ms
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"root": args.root, "card": torch.cuda.get_device_name(0),
                      "ms": out, **({"groups": groups} if groups else {}),
                      **({"comb": comb} if comb else {})}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
