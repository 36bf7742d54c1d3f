"""Time each CUDA kernel of a checkout of the port on the card, alone.

    python tools/time_kernels_torch.py [--root DIR] [--reps 10] [--seed 0]
                                       [--groups LANES ...]

Loads `privacy_auction_tpu_torch` from the checkout at DIR (this one by
default), so that two commits can be timed on one card in one call: run it
on each checkout in turns (A, B, B, A).  For each kernel row at the shapes
of the SEAL auctions (the 128x32 auction's for each row, and the group
kernels' 20x32 shapes: `quad_mul` at 160, 320, 2560 and 3840 lanes,
`base_mul_add_glv` at 1280), on random points and scalars from the seed:
the mean ms per launch (CUDA events around `reps` launches after one
untimed launch).  With --groups (this checkout's kernels only): the two
group kernels at each of LANES with 8 and with 4 threads a lane, in turns
(8 4 4 8), whatever `cuda_ec.launch_shape` would pick, under "groups":
{"kernel@lanes": {"8": [ms, ms], "4": [ms, ms]}}.  Prints the card's name
and power limit and one JSON line {"root", "card", "ms": {"row@lanes":
ms}}; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import random
import subprocess
import sys

SHAPES = (("mul_comb", 16384), ("dual_mul", 8192), ("quad_mul", 2048),
          ("base_mul_add_glv", 8192), ("scalar_mul", 8192),
          ("dual_mul_64", 8192), ("base_mul_add", 8192), ("pt_add", 8192),
          ("quad_mul", 160), ("quad_mul", 320), ("quad_mul", 2560),
          ("quad_mul", 3840), ("base_mul_add_glv", 1280))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--groups", type=int, nargs="*", default=[])
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

    def call(name, n):
        if name == "mul_comb":
            table, k = C.tensor("comb_table", dev), scalars(n)
            return lambda: cuda_ec.mul_comb(table, k)
        if name == "pt_add":
            P, Q = points(n), points(n)
            return lambda: cuda_ec.pt_add(P, Q)
        if name == "scalar_mul":
            P, k = points(n), scalars(n)
            return lambda: cuda_ec.scalar_mul(P, k)
        if name == "dual_mul_64":
            a = [points(n), scalars(n), points(n), scalars(n)]
            return lambda: cuda_ec.dual_mul(*a, COMB_WINDOWS)
        if name == "base_mul_add":
            s, P, t, g0 = scalars(n), points(n), scalars(n), C.tensor("g0_table", dev)
            return lambda: cuda_ec.base_mul_add(s, P, t, g0)
        srcs = {"dual_mul": 2, "quad_mul": 4, "base_mul_add_glv": 2}[name]
        a = [t for _ in range(srcs) for t in (points(n), scalars(n, 132))]
        if name == "dual_mul":
            return lambda: cuda_ec.dual_mul(*a, GLV_WINDOWS)
        if name == "quad_mul":
            return lambda: cuda_ec.quad_mul(*a, GLV_WINDOWS)
        s1, s2 = scalars(n, 132), scalars(n, 132)
        flags = torch.randint(0, 2, (n, 2), device=dev)
        g0 = C.tensor("g0_tables", dev)
        return lambda: cuda_ec.base_mul_add_glv(*a, s1, s2, flags, g0, GLV_WINDOWS)

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

    def forced(name, n, group):
        """A launch of a group kernel with `group` threads a lane."""
        lib = cuda_ec.build().lib
        per_block = cuda_ec.WARP // group
        tables = 4 * per_block if name == "quad_mul" else 2 + 2 * per_block
        shape = (group, -(-n // per_block), cuda_ec.WARP, tables * cuda_ec.TABLE_BYTES)
        a = [t for _ in range(4 if name == "quad_mul" else 2)
             for t in (points(n), scalars(n, 132))]
        if name == "base_mul_add_glv":
            a += [scalars(n, 132), scalars(n, 132),
                  torch.randint(0, 2, (n, 2), device=dev),
                  cuda_ec.packed_words(C.tensor("g0_tables", dev))]
        out = torch.empty((n, 3, 16), dtype=torch.int64, device=dev)
        fn = lib.pa_quad_mul if name == "quad_mul" else lib.pa_base_mul_add_glv
        return lambda: cuda_ec._check(name, fn(
            *[cuda_ec._ptr(t) for t in a], cuda_ec._ptr(out), n, GLV_WINDOWS,
            *shape, cuda_ec._stream(dev)))

    cuda_ec.build()
    out = {f"{name}@{n}": time_ms(call(name, n)) for name, n in SHAPES}
    groups = {}
    for n in args.groups:
        for name in ("quad_mul", "base_mul_add_glv"):
            runs = {8: forced(name, n, 8), 4: forced(name, n, 4)}
            ms = {8: [], 4: []}
            for g in (8, 4, 4, 8):
                ms[g].append(time_ms(runs[g]))
            groups[f"{name}@{n}"] = ms
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"root": args.root, "card": torch.cuda.get_device_name(0),
                      "ms": out, **({"groups": groups} if groups else {})}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
