#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (`privacy_auction_tpu_torch`) and nothing of the JAX
package, in eight phases; any failure raises and the exit code is non-zero:

1. the card's name and power limit (nvidia-smi);
2. builds the seven EC kernels from `privacy_auction_tpu_torch/csrc/` with
   nvcc (sm_90a) into `build/cuda_ec/`, with ptxas' register and spill
   report; then reads every table select of every kernel in the SASS
   (cuobjdump, next to nvcc): it fails unless each select loads all 16
   entries in straight-line code and no load is predicated;
3. the full kernel validator (the 64-window ladders, `mul_base`, the GLV
   dispatch and `pt_add`, edge lanes against the host oracle) with the
   launch counts set to 0 before it and read after it: every kernel must
   have run; then each of the eight kernel rows (`dual_mul` at 33 and at 64
   windows) at 4096 lanes against its plain PyTorch version on the card
   (exactly: integer limbs, tolerance 0) and sampled lanes against the host
   oracle; the two group kernels (`quad_mul`, `base_mul_add_glv`) also at
   160, 320, 1280, 2048 and 8192 lanes;
4. verified SEAL auctions at 20x32 and 128x32 bidders x bits from a seed:
   each must verify and find the plaintext maximum, and each of its four
   kernels' launch counts must rise during each auction (printed, with the
   launches by kernel and lane count);
5. CCS22 auctions at 20x32 and 64x32 from a seed with a random evaluator:
   each must find the plaintext maximum, `mul_comb`, `dual_mul` and
   `quad_mul` must rise and no other kernel may run (the protocol has no
   verification phase); the 20x32 auction's steps run once more with every
   host synchronization an error; then the setup's SHA-256 alone at 64x32;
6. one tampered PoKDLog among honest ones is rejected on the card;
7. tools/bench_ladder_torch.py at 8192 lanes (64-window ladders beside
   their GLV forms);
8. per kernel row, at a shape the 128x32 SEAL auction gives it (8192 lanes
   for the kernels that only the validator reaches), and the group kernels
   at the 20x32 auction's shapes too (`quad_mul` at 160, 320 and 2048
   lanes, `base_mul_add_glv` at 1280 and 8192): the kernel's time (CUDA
   events), the plain version's time, both outputs compared exactly
   (`max_abs_err` must be 0), the bound from the 32-bit integer multiplies
   or the bytes it needs, and ptxas' registers, stack and spills with the
   shared memory a block takes.

Prints a `kernels` JSON line, the nvidia-smi line, and last the line
{"ok": true, "device": {...}}.  Exits non-zero, printing no result, when no
CUDA device is available or the package is missing.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import random
import subprocess
import sys
import time

DEVICE = "cuda"
SEED = 20261016
AUCTIONS = ((20, 32), (128, 32))
CCS22_AUCTIONS = ((20, 32), (64, 32))
BENCH_LANES = 8192
CHECK_LANES = 4096
SAMPLED = 8
# Peak 32-bit integer multiply rate of an H100 SXM: 64 results per clock per
# SM for 32-bit integer multiply(-add) at compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput table) x 132 SMs x
# 1.98 GHz (the boost clock behind the published 67 TFLOP/s fp32 peak).
INT_MUL_RATE = 64 * 132 * 1.98e9
HBM_RATE = 3.35e12   # bytes/s, NVIDIA H100 SXM data sheet
SOURCE = "privacy_auction_tpu_torch/csrc/ec_ladders.cu"
GROUP_SOURCE = "privacy_auction_tpu_torch/csrc/ec_group.cuh"
REPLACES = {
    "mul_comb": "privacy_auction_tpu/ops/pallas_ec.py:538",
    "dual_mul": "privacy_auction_tpu/ops/pallas_ec.py:366",
    "quad_mul": "privacy_auction_tpu/ops/pallas_ec.py:404",
    "base_mul_add_glv": "privacy_auction_tpu/ops/pallas_ec.py:436",
    "scalar_mul": "privacy_auction_tpu/ops/pallas_ec.py:346",
    "dual_mul_64": "privacy_auction_tpu/ops/pallas_ec.py:366",
    "base_mul_add": "privacy_auction_tpu/ops/pallas_ec.py:496",
    "pt_add": "privacy_auction_tpu/ops/pallas_ec.py:399",
}
# the kernel rows: dual_mul serves two, at 33 windows (GLV halves, the
# protocols) and at 64 (full scalars, the validator)
ROWS = tuple(REPLACES)
SEAL_KERNELS = ROWS[:4]
CCS22_KERNELS = ("mul_comb", "dual_mul", "quad_mul")
VALIDATOR_ROWS = ROWS[4:]      # the path of the kernels only it reaches
GROUP_KERNELS = ("quad_mul", "base_mul_add_glv")
GROUP_LANES = (160, 320, 1280, 2048, 8192)
# the group kernels' timed shapes beside their rows: quad_mul's Stage1 and
# Stage2 proof passes of the 20x32 auction (8n, 16n) and Stage2 at 128x32;
# base_mul_add_glv's round-1 check (2cn) at 20x32 and 128x32
GROUP_TIMED = (("quad_mul", 160), ("quad_mul", 320), ("quad_mul", 2048),
               ("base_mul_add_glv", 1280), ("base_mul_add_glv", 8192))


def log(msg):
    print(msg, flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    from privacy_auction_tpu_torch.curves import (COMB_WINDOWS, GLV_WINDOWS,
                                                  SECP256K1 as C)
    from privacy_auction_tpu_torch.nizk import PoKDLog
    from privacy_auction_tpu_torch.ops import cuda_ec, ec
    from privacy_auction_tpu_torch.ops import field as F
    from privacy_auction_tpu_torch.ops.sha256 import sha256
    from privacy_auction_tpu_torch.ops.validate import validate_kernels
    from privacy_auction_tpu_torch.protocols import ccs22, seal

    dev = torch.device(DEVICE, 0)
    host = C.host
    t_start = time.perf_counter()

    # ---- 1. the card --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[card] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 2. build -----------------------------------------------------------
    b = cuda_ec.build()
    built = ("loaded an earlier build" if b.seconds is None
             else f"nvcc {b.seconds:.1f} s")
    log(f"[build] {built} -> {b.path}")
    resources = b.resources()
    for key, r in resources.items():
        log(f"[ptxas] {key}: {r.get('registers')} registers, "
            f"{r.get('stack_bytes')} B stack frame, {r.get('spill_stores')} B "
            f"spill stores, {r.get('spill_loads')} B spill loads")

    # ---- 2b. the table selects in SASS ----------------------------------------
    selects = cuda_ec.select_sass(b)
    for r in selects:
        log(f"[sass] {r['variant']} {r['select']}: {r['instructions']} "
            f"instructions, {r['loads']} loads ({r['predicated_loads']} "
            f"predicated) reading {r['table_bytes']} B of table, "
            f"{r['branches']} branches: {'ok' if r['ok'] else 'FAILED'}")
    unchecked = set(cuda_ec.SELECT_KERNELS) - {r["kernel"] for r in selects}
    bad = [f"{r['variant']}:{r['select']}" for r in selects if not r["ok"]]
    if unchecked or bad:
        raise AssertionError(f"selects: {sorted(unchecked)} not found in the "
                             f"SASS, {bad} missing or not constant-time as "
                             "compiled")

    # ---- 3. validator (this slice's path) and 4096-lane parity ---------------
    cuda_ec.reset_launches()
    validate_kernels(C, lanes=8, seed=SEED, device=dev)
    torch.cuda.synchronize()
    validator_launches = dict(cuda_ec.launches)
    idle = [k for k, v in validator_launches.items() if v == 0]
    if idle:
        raise AssertionError(f"validator: kernels {idle} never launched")
    log("[validate] 64-window ladders, mul_base, GLV dispatch and pt_add: "
        "edge lanes (k = 0, 1, n-1; infinity input) match host_curve; "
        f"launches {json.dumps(validator_launches)}")
    cuda_ec.reset_launches()

    rng = random.Random(SEED)
    gen = torch.Generator().manual_seed(SEED)

    def scalars(lanes, bits=256):
        ks = [rng.randrange(1 << bits) % host.n for _ in range(lanes)]
        return ks, torch.as_tensor(F.ints_to_limbs(ks)).to(dev)

    def points(lanes):
        ks, k = scalars(lanes)
        return ks, ec.mul_base(C, k)

    def kernel_inputs(name, lanes):
        """(kernel call, plain call, host oracle for lane i) on random data;
        the GLV kernels get 132-bit scalars, as the split gives them, the
        64-window ladders full scalars."""
        g0 = C.tensor("g0_tables", dev)
        if name == "mul_comb":
            ks, k = scalars(lanes)
            table = C.tensor("comb_table", dev)
            return ((lambda: cuda_ec.mul_comb(table, k)),
                    (lambda: ec.mul_comb_plain(C, table, k)),
                    lambda i: host.mul(ks[i], host.g))
        if name == "pt_add":
            (a, P), (b, Q) = points(lanes), points(lanes)
            return ((lambda: cuda_ec.pt_add(P, Q)), (lambda: ec.add(C, P, Q)),
                    lambda i: host.mul(a[i] + b[i], host.g))
        if name in ("scalar_mul", "base_mul_add", "dual_mul_64"):
            (a, P), (b, Q) = points(lanes), points(lanes)
            (ss, s), (ts, t) = scalars(lanes), scalars(lanes)
            if name == "scalar_mul":
                return ((lambda: cuda_ec.scalar_mul(P, s)),
                        (lambda: ec.scalar_mul_windows_plain(C, P, s)),
                        lambda i: host.mul(a[i] * ss[i], host.g))
            if name == "base_mul_add":
                g0b = C.tensor("g0_table", dev)
                return ((lambda: cuda_ec.base_mul_add(s, P, t, g0b)),
                        (lambda: ec.base_mul_add_plain(C, s, P, t)),
                        lambda i: host.mul(ss[i] + a[i] * ts[i], host.g))
            return ((lambda: cuda_ec.dual_mul(P, s, Q, t, COMB_WINDOWS)),
                    (lambda: ec.dual_mul_windows_plain(C, P, s, Q, t,
                                                       COMB_WINDOWS)),
                    lambda i: host.mul(a[i] * ss[i] + b[i] * ts[i], host.g))
        nsrc = {"dual_mul": 2, "quad_mul": 4, "base_mul_add_glv": 2}[name]
        srcs = [points(lanes) + scalars(lanes, 132) for _ in range(nsrc)]
        args = [t for a, P, s, k in srcs for t in (P, k)]
        if name == "dual_mul":
            return ((lambda: cuda_ec.dual_mul(*args, GLV_WINDOWS)),
                    (lambda: ec.dual_mul_windows_plain(C, *args, GLV_WINDOWS)),
                    lambda i: host.mul(sum(a[i] * s[i] for a, _, s, _ in srcs),
                                       host.g))
        if name == "quad_mul":
            return ((lambda: cuda_ec.quad_mul(*args, GLV_WINDOWS)),
                    (lambda: ec.quad_mul_windows_plain(C, *args, GLV_WINDOWS)),
                    lambda i: host.mul(sum(a[i] * s[i] for a, _, s, _ in srcs),
                                       host.g))
        ss1, s1 = scalars(lanes, 132)
        ss2, s2 = scalars(lanes, 132)
        flags = torch.randint(0, 2, (lanes, 2), generator=gen).to(dev)
        fl = flags.cpu().tolist()
        lam = C.glv.lam

        def want(i):
            e = ((-1) ** fl[i][0] * ss1[i] + (-1) ** fl[i][1] * ss2[i] * lam
                 + sum(a[i] * s[i] for a, _, s, _ in srcs))
            return host.mul(e % host.n, host.g)
        return ((lambda: cuda_ec.base_mul_add_glv(*args, s1, s2, flags, g0,
                                                  GLV_WINDOWS)),
                (lambda: ec.base_mul_add_glv_plain(C, *args, s1, s2, flags,
                                                   GLV_WINDOWS)),
                want)

    parity = [(name, CHECK_LANES) for name in ROWS]
    parity += [(name, lanes) for name in GROUP_KERNELS for lanes in GROUP_LANES]
    for name, lanes in parity:
        run_k, run_p, want = kernel_inputs(name, lanes)
        got = run_k()
        ref = run_p()
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            bad = int((got != ref).any(-1).any(-1).sum())
            raise AssertionError(f"{name}: {bad} of {lanes} lanes differ "
                                 f"from the plain version")
        for i in rng.sample(range(lanes), min(SAMPLED, lanes)):
            if ec.decode_host_point(C, got[i]) != want(i):
                raise AssertionError(f"{name}: lane {i} disagrees with host_curve")
        log(f"[parity] {name}: {lanes} lanes equal the plain version, "
            f"{SAMPLED} sampled lanes equal host_curve")

    def by_lanes(counts):
        return {f"{k}@{n}": v for (k, n), v in sorted(counts.items())}

    # ---- 4. verified auctions (the main path) -----------------------------------
    auction_launches = {}
    auction_lanes = {}
    for n, c in AUCTIONS:
        bids = [rng.randrange(1 << c) for _ in range(n)]
        times = {}
        cuda_ec.reset_launches()
        t0 = time.perf_counter()
        res = seal.run_auction(C, bids, c, verify=True,
                               generator=torch.Generator().manual_seed(SEED + n),
                               device=dev, times=times)
        wall = time.perf_counter() - t0
        counts = dict(cuda_ec.launches)
        if not res.verified or res.max_bid != max(bids):
            raise AssertionError(f"SEAL {n}x{c}: verified={res.verified} "
                                 f"max_bid={res.max_bid} != {max(bids)}")
        idle = [k for k in SEAL_KERNELS if counts[k] == 0]
        if idle:
            raise AssertionError(f"SEAL {n}x{c}: kernels {idle} never launched")
        auction_launches[(n, c)] = counts
        auction_lanes[(n, c)] = dict(cuda_ec.launch_lanes)
        log(f"[seal {n}x{c}] verified, max_bid={res.max_bid}, wall {wall:.3f} s; "
            "phases " + ", ".join(f"{k} {v:.3f} s" for k, v in times.items()))
        log(f"[seal {n}x{c}] launches {json.dumps(counts)}")
        log(f"[seal {n}x{c}] launches by kernel@lanes "
            f"{json.dumps(by_lanes(cuda_ec.launch_lanes))}")

    # ---- 5. CCS22 auctions ---------------------------------------------------------
    ccs22_launches = {}
    for n, c in CCS22_AUCTIONS:
        bids = [rng.randrange(1 << c) for _ in range(n)]
        eval_id = rng.randrange(n)
        times = {}
        ccs22.pp_or_make(C, dev)          # the CRS: host hash-to-curve, once
        cuda_ec.reset_launches()
        t0 = time.perf_counter()
        res = ccs22.run_auction(C, bids, c, eval_id,
                                generator=torch.Generator().manual_seed(SEED + n),
                                device=dev, times=times)
        wall = time.perf_counter() - t0
        counts = dict(cuda_ec.launches)
        if res.max_bid != max(bids):
            raise AssertionError(f"CCS22 {n}x{c}: max_bid={res.max_bid} != "
                                 f"{max(bids)}")
        idle = [k for k in CCS22_KERNELS if counts[k] == 0]
        stray = [k for k, v in counts.items() if v and k not in CCS22_KERNELS]
        if idle or stray:
            raise AssertionError(f"CCS22 {n}x{c}: kernels {idle} never "
                                 f"launched, {stray} launched")
        ccs22_launches[(n, c)] = counts
        log(f"[ccs22 {n}x{c}] evaluator {eval_id}, max_bid={res.max_bid}, wall "
            f"{wall:.3f} s; phases " + ", ".join(f"{k} {v:.3f} s"
                                                 for k, v in times.items()))
        log(f"[ccs22 {n}x{c}] launches {json.dumps(counts)}")
        log(f"[ccs22 {n}x{c}] launches by kernel@lanes "
            f"{json.dumps(by_lanes(cuda_ec.launch_lanes))}")
        if (n, c) == CCS22_AUCTIONS[0]:
            # the steps once more, from the same draws, with every host
            # synchronization an error: nothing is read back between steps
            pp = ccs22.pp_or_make(C, dev)
            draws = ccs22.draw(C, torch.Generator().manual_seed(SEED + n), n,
                               c, dev)
            pre = ccs22._precompute(C, pp, res.board.setup.X, draws)
            bits = torch.as_tensor(seal.bids_to_bits(bids, c), device=dev)
            eid = torch.tensor(eval_id, device=dev)
            g1n = pp.g1.expand(n, 3, F.LIMBS)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                announced = ccs22._scan_steps(C, pre, g1n, bits, eid)[0]
            finally:
                torch.cuda.set_sync_debug_mode(0)
            if not torch.equal(announced, res.board.announced):
                raise AssertionError(f"CCS22 {n}x{c}: the steps rerun announced "
                                     "other bits")
            log(f"[ccs22 {n}x{c}] the {c} steps ran with host syncs made "
                "errors: none occurred, the same bits were announced")

    # the setup's SHA-256 alone at the larger size: the parties' hashes
    # (4c scalars each, one batch) and the evaluator's (its own secrets and
    # all n*c OT betas, one message)
    n, c = CCS22_AUCTIONS[-1]
    for what, shape in (("parties'", (n, 4 * c * 32)),
                        ("evaluator's", (4 * c * 32 + n * c * 32,))):
        msg = torch.randint(0, 256, shape, generator=torch.Generator()
                            .manual_seed(SEED), dtype=torch.uint8).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sha256(msg)
        torch.cuda.synchronize()
        log(f"[ccs22 {n}x{c}] the {what} SHA-256 alone: {shape[-1]} B a "
            f"message, {(shape[-1] + 9 + 63) // 64} blocks, "
            f"{time.perf_counter() - t0:.3f} s")

    # ---- 6. a tampered PoKDLog is rejected ----------------------------------------
    n_t = 8
    ids = torch.arange(n_t, device=dev)
    pub, _ = seal.round_one_batch(C, torch.Generator().manual_seed(SEED), n_t, 1,
                                  ids)
    ok = seal.verify_round_one_batch(C, pub, ids)
    rho = pub.pok_x.rho.clone()
    rho[0, 3, 0] ^= 1
    bad = seal.verify_round_one_batch(
        C, pub._replace(pok_x=PoKDLog(pub.pok_x.eps, rho)), ids)
    expect = torch.ones_like(bad)
    expect[0, 3] = False
    if not bool(ok.all()) or not torch.equal(bad, expect):
        raise AssertionError(f"tamper check: honest {ok.tolist()}, "
                             f"tampered {bad.tolist()}")
    log("[tamper] the PoKDLog with a flipped rho limb is rejected, its "
        f"{n_t - 1} neighbours pass")

    # ---- 7. the ladder bench ------------------------------------------------------
    spec = importlib.util.spec_from_file_location(
        "bench_ladder_torch",
        pathlib.Path(__file__).resolve().parent / "tools" / "bench_ladder_torch.py")
    bench_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench_mod)
    log("[bench] tools/bench_ladder_torch.py --lanes "
        f"{BENCH_LANES}: {json.dumps(bench_mod.bench([BENCH_LANES], device=dev)[0])}")

    # ---- 8. kernel times at the 128x32 auction's shapes -----------------------------
    n, c = AUCTIONS[-1]
    shapes = {
        "mul_comb": 4 * c * n,       # round-1 keys and nonce commitments
        "dual_mul": 2 * c * n,       # Y^x and R^x for every step
        "quad_mul": 16 * n,          # one Stage2 proof pass
        "base_mul_add_glv": 2 * c * n,   # round-1 PoKDLog verification
        # the validator's kernels, at dual_mul's shape, beside their GLV forms
        "scalar_mul": 2 * c * n, "dual_mul_64": 2 * c * n,
        "base_mul_add": 2 * c * n, "pt_add": 2 * c * n,
    }
    windows = {"dual_mul": GLV_WINDOWS, "quad_mul": GLV_WINDOWS,
               "base_mul_add_glv": GLV_WINDOWS, "scalar_mul": COMB_WINDOWS,
               "dual_mul_64": COMB_WINDOWS, "base_mul_add": COMB_WINDOWS}
    # bytes each input is read once and the output written once: int64
    # points 384 B, scalars 128 B, sign flags 16 B; the constant tables once
    bytes_per_lane = {"mul_comb": 128 + 384, "dual_mul": 2 * 512 + 384,
                      "quad_mul": 4 * 512 + 384,
                      "base_mul_add_glv": 2 * 512 + 2 * 128 + 16 + 384,
                      "scalar_mul": 512 + 384, "dual_mul_64": 2 * 512 + 384,
                      "base_mul_add": 384 + 2 * 128 + 384,
                      "pt_add": 2 * 384 + 384}
    table_bytes = {"mul_comb": 64 * 16 * 384, "base_mul_add_glv": 2 * 16 * 384,
                   "base_mul_add": 16 * 384}
    report = []
    timed = [(name, shapes[name], False) for name in ROWS]
    timed += [(name, lanes, True) for name, lanes in GROUP_TIMED]
    for name, lanes, extra in timed:
        run_k, run_p, _ = kernel_inputs(name, lanes)
        run_k()
        torch.cuda.synchronize()
        reps = 5
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            got = run_k()
        e1.record()
        torch.cuda.synchronize()
        ms = e0.elapsed_time(e1) / reps
        e0.record()
        ref = run_p()
        e1.record()
        torch.cuda.synchronize()
        plain_ms = e0.elapsed_time(e1)
        err = int((got - ref).abs().max())
        if err:
            raise AssertionError(f"{name}: kernel and plain differ at {lanes} lanes")
        ops_s = cuda_ec.int_muls(name.removesuffix("_64"), lanes,
                                 windows.get(name, GLV_WINDOWS)) / INT_MUL_RATE
        bytes_s = (lanes * bytes_per_lane[name]
                   + table_bytes.get(name, 0)) / HBM_RATE
        path = ("seal 20x32" if name in SEAL_KERNELS else "validator")
        row = name.removesuffix("_64")
        if name in GROUP_KERNELS:
            row += f"<{cuda_ec.launch_shape(name, lanes)[0]}>"
        report.append({
            "name": f"{name}@{lanes}" if extra else name, "route": "cuda",
            "source": GROUP_SOURCE if name in GROUP_KERNELS else SOURCE,
            "replaces": REPLACES[name],
            "launches": (auction_lanes[AUCTIONS[0]].get((name, lanes), 0) if extra
                         else auction_launches[AUCTIONS[0]][name]
                         if name in SEAL_KERNELS else validator_launches[name]),
            "launches_path": path,
            "launches_seal_128x32": (
                auction_lanes[AUCTIONS[-1]].get((name, lanes), 0) if extra
                else auction_launches[AUCTIONS[-1]][name]),
            **{f"launches_ccs22_{a}x{b}": ccs22_launches[(a, b)][name]
               for a, b in CCS22_AUCTIONS if not extra},
            "launches_validator": validator_launches[name],
            "lanes": lanes, "windows": windows.get(name), "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": 1e3 * max(ops_s, bytes_s),
            "bound_by": "operations" if ops_s >= bytes_s else "bytes",
            "library_ms": None,
            **resources.get(row, {}),
            "threads_a_lane": (cuda_ec.launch_shape(name, lanes)[0]
                               if name in GROUP_KERNELS else 1),
            "smem_bytes": (cuda_ec.launch_shape(name, lanes)[3]
                           if name in GROUP_KERNELS else 0),
        })
        log(f"[time] {name} at {lanes} lanes: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.1f} ms, bound {1e3 * max(ops_s, bytes_s):.4f} ms")

    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": report}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
