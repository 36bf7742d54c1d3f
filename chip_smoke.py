#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (`privacy_auction_tpu_torch`) and nothing of the JAX
package, in these phases; any failure raises and the exit code is non-zero:

1. the card's name and power limit (nvidia-smi);
2. builds the seven EC kernels and the SHA-256 kernel from
   `privacy_auction_tpu_torch/csrc/` with nvcc (sm_90a, one nvcc a source,
   started together) into `build/cuda_ec/`, with ptxas' register and spill
   report; then reads every table select of every kernel variant in the
   SASS (cuobjdump, next to nvcc): it fails unless each of the 12 variants
   that look up tables (the six table-lookup kernels at both of their
   threads a lane, `cuda_ec.GROUPS`) has a select that loads all 16 entries in
   straight-line code with no load predicated, and prints how many selects
   it checked;
2c. the multi-process hub auction (`runtime/party.py`) at 20x2: 20 party
   processes on the card, spawned after this process built the native hub
   (make) and the kernels; bids from the seed with their top bit set
   (Stage1, then Stage2).  c is cut from 32 to 2 for the time limit: the
   other 30 steps repeat the same shapes.  Every party must return (the
   plaintext maximum, True), the hub's meters must equal the formula of
   tests/test_native_auction.py exactly, every party must report `cuda`,
   and in every party `mul_comb`, `dual_mul`, `quad_mul`,
   `base_mul_add_glv` and `sha256` must rise and no other kernel run (counts and
   devices come back in files beside the hub's socket, not through the
   hub); it prints the wall time, the slowest party's time, the meters
   and the parties' launches by kernel and lane count, and every lane
   count the parties launched joins phase 3's parity list;
2d. the bidder mesh (`parallel/`, `run_auction(mesh=...)`): two spawned
   ranks on the card, in a gloo group, run a verified fused SEAL auction
   and a CCS22 auction at 20x8 on a mesh of two, and one spawned rank in
   an NCCL group runs the SEAL auction on a mesh of one, while this
   process runs both unsharded (tests/torch_mesh_cases.py; the ranks
   start after this process built the kernels).  Every rank's outcome and
   whole board must equal the unsharded run's bit for bit, and each
   rank's kernels must launch at the unsharded lane counts divided by the
   mesh size, as often (CCS22's evaluator hash at one lane on every rank); it prints each rank's wall, backend and launches
   by kernel and lane count, and the ranks' lane counts join phase 3's
   parity list;
3. the full kernel validator (the 64-window ladders, `mul_base`, the GLV
   dispatch and `pt_add`, edge lanes against the host oracle) with the
   launch counts set to 0 before it and read after it: every EC kernel
   must have run, and SHA-256 not (the validator hashes nothing); then each
   kernel row against its plain PyTorch version on the
   card (exactly: integer limbs, tolerance 0) and sampled lanes against the
   host oracle: the eight rows of the seven group kernels (`dual_mul` at
   33 and at 64 windows) at 1, 15, 17, 300 and 2053 lanes and at the lane
   counts the auctions (fused and metered), the hub's parties (phase 2c),
   the mesh's ranks (2d), the validator and the ladder bench launch them
   at (`pt_add` at 8, 2048 and 20480, with the validator's special lanes
   P + P, P + (-P), P + infinity and infinity + Q), each lane count once,
   each at both of its threads a lane (8 and 4; `mul_comb` 8 and 2);
3b. the SHA-256 kernel against its plain version on the card and against
   hashlib, exactly: messages of 0, 55, 56, 63, 64 and 119 bytes (block
   boundaries), 218, 543, 1066 and 1846 (the PoKDLog, PoWFCom, Stage1 and
   Stage2 transcripts) and 4096 (a CCS22 bidder's message at c = 32), each
   at 1, 20, 64 and 2053 lanes, and the one-lane evaluator messages of
   CCS22 20x32, 64x32 and 1024x64 (385, 1,089 and 32,897 blocks; the plain
   version is not run on the last, one eager chain of some 100M ops); each
   case timed; then the clocks of a round's critical chain on one thread;
4. verified SEAL auctions at 20x32 and 128x8 bidders x bits from a seed
   (the fused driver; the second cut from 128x32 to 128x8 to leave time
   for phases 2c and 6b), whose steps replay one CUDA graph a stage: each
   must verify and find the plaintext maximum, capture a graph for each
   stage it reaches (Stage2 after a deciding step that is not the last)
   and replay it for every step of the stage, and launch its four EC
   kernels and SHA-256 at exactly the lane counts the fused driver's phases
   give them (`seal_lanes`: `quad_mul` and `sha256` twice a step, for the
   proof and its check, besides the commitment's and round one's), a
   graph's launches counted at each replay; the 20x32 Stage1 graph must
   hold fewer than 70,000 kernel nodes (its hashes single launches); it prints the launches by kernel and lane count and, for each
   graph, its GPU kernels a step (kernel nodes), the seconds of its
   warm-up step, capture, instantiation and replays, and the device
   memory its pool took;
4a. the role-metered SEAL driver at 20x32 from the same seed and bids as
   the fused 20x32 auction of phase 4: both must verify with the same
   max_bid and deciding bits and publish the same board, limb for limb;
   it prints both walls and their phase times;
4b. the role-metered SEAL auction at 20x8 (cut from 20x32 for the same
   reason; a step's shapes do not depend on c) through the CLI's run function
   (`cli.run_seal`, no warm-up: the build is loaded): it must verify and
   find the plaintext maximum, and the four kernels and SHA-256 must rise;
   it prints
   the CLI's per-role report and the launches by kernel and lane count;
5. CCS22 auctions at 20x32 and 64x32 from a seed with a random evaluator
   (the fused driver): each must find the plaintext maximum, `mul_comb`,
   `dual_mul`, `quad_mul` and `sha256` must rise and no other kernel may
   run (the protocol has no verification phase), and its c steps must be
   c replays of one CUDA graph (it prints the graph's kernel nodes, its
   warm-up, capture, instantiation and replay seconds and its memory);
   the 20x32 auction's steps run once more uncaptured from the same draws,
   with every host synchronization an error, and must give the graph's
   board limb for limb;
5b. the role-metered CCS22 auction at 20x32 from the fused 20x32 run's
   draws: it must find the plaintext maximum and publish the fused run's
   board (the OT messages G, H, C0, C1 as SEC1 bytes, the rest limb for
   limb), the same three kernels must rise and no other; it prints the
   CLI's per-role report;
6. one tampered PoKDLog among honest ones is rejected on the card; then
   the metered SEAL loop at 3x3, bids [5, 3, 6], with the honest control
   and the five tamper hooks of tests/test_adversarial.py
   (tests/torch_metered_cases.py): the control must verify and match the
   JAX package's golden vectors (deciding bits, bytes, the hook's calls,
   the checks run), each tampered auction must return verified=False and
   max_bid=-1 at the check where the JAX loop stopped;
6b. NIST P-256 on the card: a fused verified SEAL auction and a fused
   CCS22 auction at 20x2 (c cut from 32 to 2 for the time limit) from the
   seed; each must find the plaintext maximum (SEAL verified), no EC
   kernel may launch (P-256 runs the generic plain path) and SHA-256 must
   (the hash does not depend on the curve); it prints the phase times;
7. tools/bench_ladder_torch.py at 8192 lanes (64-window ladders beside
   their GLV forms); then the port's tools: tools/run_sweep_torch.py over
   the first 4 pairs of params.txt, in a process of its own that runs
   beside phases 6 and 6b (each verified SEAL and CCS22 auction must find
   the maximum), and through their `main` tools/profile_phases_torch.py
   (one timed call a program), tools/bench_seal_parts_torch.py and
   tools/demo_native_board_torch.py at 20x4 (each must exit 0; the demo
   must launch no kernel);
8. the kernels line: per kernel row, at a shape the 128x8 SEAL auction
   gives it (2048 lanes for the kernels that only the validator reaches),
   and the group kernels at the other auctions' shapes too, the metered
   drivers' included (`mul_comb` at 20-20480 lanes, `dual_mul` at 20, 40,
   1280 and 4096, `quad_mul` at 20, 160, 320, 2048 and 3840,
   `base_mul_add_glv` at 40 and 1280; `scalar_mul` and `base_mul_add` at
   the validator's 8; `pt_add` at 8 and 20480; the hub parties' and the
   mesh ranks' own lane counts): the kernel's time (CUDA events around 5 launches,
   which holds the wrapper's host time where that is longer: pt_add's
   device time is tools/time_kernels_torch.py's `device_ms`), the plain
   version's time, both outputs compared exactly (`max_abs_err` must be
   0), all taken in phase 3 on its inputs; the
   bound from the 32-bit integer multiplies or the bytes it needs, and
   ptxas' registers, stack and spills with the threads a lane, threads a
   block and shared memory a block of the launch; then the SHA-256 rows,
   phase 3b's cases (the row named `sha256`: 20 lanes of a Stage1
   transcript, a SEAL 20x32 step's), each with its launches by lane count
   on every path, its bound (the larger of its 32-bit integer operations
   over the card's rate, its bytes over the memory rate, and one lane's
   chain of rounds at the clocks measured in 3b) and ptxas' registers.

Each log line starts with the seconds since the start.  Prints its total
time, a `kernels` JSON line, the nvidia-smi line, and last the line
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
AUCTIONS = ((20, 32), (128, 8))
HUB = (20, 2)            # party processes x bits; c cut from 32 for time
HUB_KERNELS = ("mul_comb", "dual_mul", "quad_mul", "base_mul_add_glv",
               "sha256")
P256_AUCTION = (20, 2)   # bidders x bits; c cut from 32 for time
CCS22_AUCTIONS = ((20, 32), (64, 32))
MESH = (20, 8)           # bidders x bits of the mesh phase's auctions
# (backend, ranks, protocols) of the mesh phase: two ranks on one card
# need gloo (NCCL refuses two ranks on one device); NCCL runs a mesh of one
MESH_RUNS = (("gloo", 2, ("seal", "ccs22")), ("nccl", 1, ("seal",)))
TOOLS_AUCTION = (20, 4)  # the phase-profile, SEAL-parts and demo tools
SWEEP_PAIRS = 4          # the first pairs of params.txt
BENCH_LANES = 8192
SAMPLED = 8
# Peak 32-bit integer multiply rate of an H100 SXM: 64 results per clock per
# SM for 32-bit integer multiply(-add) at compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput table) x 132 SMs x
# 1.98 GHz (the boost clock behind the published 67 TFLOP/s fp32 peak).
BOOST_CLOCK = 1.98e9
INT_MUL_RATE = 64 * 132 * BOOST_CLOCK
# 32-bit integer add, logic op, shift and funnel shift run at the same 64
# results per clock per SM at compute capability 9.0 (the same table)
INT_OP_RATE = 64 * 132 * BOOST_CLOCK
HBM_RATE = 3.35e12   # bytes/s, NVIDIA H100 SXM data sheet
SOURCE = "privacy_auction_tpu_torch/csrc/ec_ladders.cu"
GROUP_SOURCE = "privacy_auction_tpu_torch/csrc/ec_group.cuh"
SHA_SOURCE = "privacy_auction_tpu_torch/csrc/sha256.cu"
# the JAX package's SHA-256 loop that the kernel is the counterpart of (not
# a Pallas kernel)
SHA_REPLACES = "privacy_auction_tpu/ops/sha256.py:101"
HASH = "sha256"
# SHA-256 (phase 3b): the lane counts and message lengths held to the
# plain version and hashlib: the block boundaries, the PoKDLog, PoWFCom,
# Stage1 and Stage2 transcripts, a CCS22 bidder's message at c = 32; and
# the one-lane evaluator messages of CCS22 20x32, 64x32 and 1024x64 (385,
# 1,089 and 32,897 blocks), the plain version on the first two only (the
# third would be one eager chain of some 100M ops)
SHA_LANES = (1, 20, 64, 2053)
SHA_LENGTHS = (0, 55, 56, 63, 64, 119, 218, 543, 1066, 1846, 4 * 32 * 32)
SHA_CHAINS = ((20, 32), (64, 32), (1024, 64))
SHA_PLAIN_CHAINS = ((20, 32), (64, 32))
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
# protocols) and at 64 (full scalars, the validator); every row is a group
# kernel (several threads a lane on csrc/ec_group.cuh)
ROWS = tuple(REPLACES)
SEAL_KERNELS = ROWS[:4]
# the kernels each auction's path must launch, and no other: the EC kernels
# and SHA-256 (every proof's challenge, CCS22's commitment hash)
SEAL_PATH = SEAL_KERNELS + ("sha256",)
CCS22_KERNELS = ("mul_comb", "dual_mul", "quad_mul", "sha256")
SELECT_VARIANTS = 12    # the six table-lookup kernels, each at both G
RAGGED_LANES = (1, 15, 17, 300, 2053)   # part of a block, ragged blocks
# the lane counts the auctions launch each group row at: mul_comb at SEAL
# 20x32 (round one 4nc, commit 5nc) and 128x8, and at CCS22 20x32 and
# 64x32 (n, nc, 4nc); dual_mul at 2nc of SEAL 20x32 and 128x8 and of CCS22
# 20x32 and 64x32; quad_mul's proof passes (8n, 16n) and the commit's (4nc,
# 6nc) at SEAL 20x32 and 128x8, and CCS22's OT masks (nc) at 20x32 and
# 64x32; base_mul_add_glv's round-one check (2cn) at 20x32 and 128x8; the
# 64-window rows at the validator's 8 and the ladder bench's 8192.  The
# metered drivers add: SEAL 20x8's commit and its check (mul_comb 5nc =
# 800, quad_mul 4nc = 640 and 6nc = 960), round one a step (mul_comb 4n =
# 80), its check (base_mul_add_glv 2n = 40) and its ciphertexts (dual_mul
# 2n = 40); CCS22 20x32's BES encoding and OT recovery (dual_mul n = 20)
# and OT reply (quad_mul n = 20)
AUCTION_LANES = {
    "mul_comb": (20, 64, 80, 640, 800, 2048, 2560, 3200, 4096, 5120, 8192),
    "dual_mul": (20, 40, 1280, 2048, 4096), "dual_mul_64": (8, 8192),
    "quad_mul": (20, 160, 320, 640, 960, 1024, 2048, 2560, 3840, 4096, 6144),
    "base_mul_add_glv": (40, 1280, 2048),
    "scalar_mul": (8, 8192), "base_mul_add": (8, 8192),
    "pt_add": (8, 2048, 20480),
}
SEAL_METERED = (20, 8)   # the role-metered SEAL auction (phase 4b)
METERED = (20, 32)       # the role-metered CCS22 auction (phase 5b)
# the group rows' timed shapes beside their rows (the 128x8 auction's):
# the other auctions' shapes and the metered drivers' (the hub's and the
# mesh's lane counts are added from their runs)
GROUP_TIMED = (tuple(("mul_comb", n) for n in AUCTION_LANES["mul_comb"]
                     if n != 4 * AUCTIONS[-1][0] * AUCTIONS[-1][1])
               + (("dual_mul", 20), ("dual_mul", 40), ("dual_mul", 1280),
                  ("dual_mul", 4096), ("quad_mul", 20), ("quad_mul", 160),
                  ("quad_mul", 320), ("quad_mul", 2048), ("quad_mul", 3840),
                  ("base_mul_add_glv", 40), ("base_mul_add_glv", 1280),
                  ("scalar_mul", 8), ("base_mul_add", 8))
               + (("pt_add", 8), ("pt_add", 20480)))


_T0 = time.perf_counter()


def log(msg):
    """A line of the run's log, after the seconds since the start."""
    print(f"{time.perf_counter() - _T0:7.1f} {msg}", flush=True)


class MemorySampler:
    """The card's used memory (nvidia-smi, MiB): once now (`base`), then every
    `period` seconds in a thread until `stop()`, keeping the largest."""

    period = 1.0

    def __init__(self):
        import threading

        self.base = self.peak = self._read()
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    @staticmethod
    def _read() -> int:
        out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, check=True)
        return int(out.stdout.split()[0])

    def _run(self):
        while not self._done.wait(self.period):
            self.peak = max(self.peak, self._read())

    def stop(self):
        self._done.set()
        self._thread.join()


def hub_phase(n: int, c: int, device, memory=None):
    """Phase 2c: the hub auction of n party processes at c bits on `device`,
    checked; returns the parties' launches by kernel and by (kernel, lanes),
    summed.  `memory`: a MemorySampler class (None: no memory reading)."""
    from privacy_auction_tpu_torch.ops import cuda_ec
    from privacy_auction_tpu_torch.runtime import party
    from privacy_auction_tpu_torch.utils import trackers as T

    hub_rng = random.Random(SEED + 1)
    bids = [(1 << (c - 1)) | hub_rng.randrange(1 << (c - 1)) for _ in range(n)]
    t0 = time.perf_counter()
    party.warm_build(device)            # make -C native; the kernels are built
    log(f"[hub] native hub and kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    reports = []
    cuda_ec.reset_launches()
    mem = memory() if memory is not None else None
    t0 = time.perf_counter()
    try:
        results, meters = party.run_hub_auction(n, c, bids, seed=SEED,
                                                device=device, reports=reports,
                                                warm=False)
    finally:
        if mem is not None:
            mem.stop()
    hub_wall = time.perf_counter() - t0
    want = max(bids)
    if results != [(want, True)] * n:
        raise AssertionError(f"hub {n}x{c}: results {results}, want "
                             f"({want}, True) from every party")
    deciding = [(want >> (c - 1 - s)) & 1 for s in range(c)]
    per_party, stage2 = c * T.SEAL_COMMIT_PER_BIT, False
    for s in range(c):
        per_party += T.SEAL_ROUND1 + (T.SEAL_ROUND2_S2 if stage2
                                      else T.SEAL_ROUND2_S1)
        stage2 = stage2 or bool(deciding[s])
    want_meters = {"bidder": n * per_party, "verifier": n * n * per_party,
                   "result": 2 * n * party.RESULT_BYTES}
    want_meters["total"] = sum(want_meters.values())
    if meters != want_meters:
        raise AssertionError(f"hub {n}x{c}: meters {meters} != {want_meters}")
    devices = sorted({r["device"] for r in reports})
    if len(reports) != n or any(not r["device"].startswith(str(device))
                                for r in reports):
        raise AssertionError(f"hub {n}x{c}: {len(reports)} reports, devices "
                             f"{devices}")
    for r in reports:
        idle = [k for k in HUB_KERNELS if r["launches"][k] == 0]
        stray = [k for k, v in r["launches"].items() if v and k not in HUB_KERNELS]
        if idle or stray:
            raise AssertionError(f"hub {n}x{c}: party {r['pid']}: kernels "
                                 f"{idle} never launched, {stray} launched")
    if any(cuda_ec.launches.values()):
        raise AssertionError("hub: the driver process launched kernels")
    hub_launches = {k: sum(r["launches"][k] for r in reports)
                    for k in cuda_ec.launches}
    hub_lanes: dict = {}
    for r in reports:
        for key, v in r["launch_lanes"].items():
            hub_lanes[key] = hub_lanes.get(key, 0) + v
    slowest = max(reports, key=lambda r: r["seconds"])
    log(f"[hub {n}x{c}] {n} party processes on {devices}, bids {bids}: every "
        f"party verified and found max_bid={want}; wall {hub_wall:.3f} s, "
        f"slowest party {slowest['seconds']:.3f} s (party {slowest['pid']})")
    if mem is not None:
        log(f"[hub {n}x{c}] device memory used (nvidia-smi, every "
            f"{mem.period} s): {mem.base} MiB before, peak {mem.peak} MiB "
            f"during the auction, {(mem.peak - mem.base) / n:.0f} MiB a party")
    log(f"[hub {n}x{c}] meters {json.dumps(meters)} = the formula (bidder n x "
        f"{per_party}, verifier n^2 x {per_party}, result 2n x 9)")
    log(f"[hub {n}x{c}] launches, all parties {json.dumps(hub_launches)}")
    log(f"[hub {n}x{c}] launches by kernel@lanes, all parties "
        f"{json.dumps({f'{k}@{l}': v for (k, l), v in sorted(hub_lanes.items())})}")
    return hub_launches, hub_lanes


def seal_lanes(n: int, c: int, deciding) -> dict:
    """The kernel launches of a fused SEAL auction at n x c (secp256k1,
    verified), by (kernel, lanes): the commitment's comb (5nc) and PoWFCom
    (quad_mul 4nc), its check (quad_mul 6nc), round one's comb (4nc) and
    its check (base_mul_add_glv 2nc), the ciphertext candidates (dual_mul
    2nc), then a proof and its check a step (quad_mul 8n each before the
    junction, 16n after it).  SHA-256, a launch a challenge: the
    commitment's PoKDLogs (2nc) and PoWFCom (nc), their check (the same
    two), round one's PoKDLogs and their check (2nc each), then a proof and
    its check a step (n each)."""
    want: dict = {}
    for key in (("mul_comb", 5 * n * c), ("mul_comb", 4 * n * c),
                ("quad_mul", 4 * n * c), ("quad_mul", 6 * n * c),
                ("base_mul_add_glv", 2 * n * c), ("dual_mul", 2 * n * c),
                (HASH, 2 * n * c), (HASH, n * c), (HASH, 2 * n * c),
                (HASH, n * c), (HASH, 2 * n * c), (HASH, 2 * n * c)):
        want[key] = want.get(key, 0) + 1
    stage2 = False
    for bit in deciding:
        for key in (("quad_mul", 16 * n if stage2 else 8 * n), (HASH, n)):
            want[key] = want.get(key, 0) + 2
        stage2 = stage2 or bool(bit)
    return want


def board_diff(a, b, path="board"):
    """The first path at which two boards differ (a tensor's limbs, or a
    message present in one only), or None."""
    if a is None or b is None:
        return None if a is None and b is None else path
    if hasattr(a, "shape"):
        import torch

        return None if torch.equal(a, b) else path
    if len(a) != len(b):
        return path
    names = getattr(a, "_fields", range(len(a)))
    for name, x, y in zip(names, a, b):
        diff = board_diff(x, y, f"{path}.{name}")
        if diff:
            return diff
    return None


def _tests_module(name):
    tests = str(pathlib.Path(__file__).resolve().parent / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    return importlib.import_module(name)


def mesh_phase(n: int, c: int, device, runs=MESH_RUNS):
    """Phase 2d: SEAL (verified, fused) and CCS22 at n x c on each
    (backend, ranks, protocols) mesh of `runs` in spawned ranks on
    `device`, all meshes at once, and meanwhile unsharded in this process;
    every rank must equal the unsharded run and launch each kernel at the
    unsharded lane counts / ranks.  Returns the first mesh's rank-0
    launches by (kernel, lanes), summed over its auctions, and every
    (kernel, lanes) a rank launched."""
    MC = _tests_module("torch_mesh_cases")
    m_rng = random.Random(SEED + 2)
    jobs = {"seal": {"protocol": "seal", "c": c, "seed": SEED + 2,
                     "verify": True,
                     "bids": [m_rng.randrange(1 << c) for _ in range(n)]},
            "ccs22": {"protocol": "ccs22", "c": c, "seed": SEED + 3,
                      "eval_id": m_rng.randrange(n),
                      "bids": [m_rng.randrange(1 << c) for _ in range(n)]}}
    t0 = time.perf_counter()
    meshes = [(backend, ranks, names,
               MC.Ranks(ranks, [jobs[k] for k in names], backend, device))
              for backend, ranks, names in runs]
    want = {}
    for name, job in jobs.items():
        want[name] = MC.run_job(job, device)
        if want[name]["max_bid"] != max(job["bids"]) or \
                want[name]["verified"] is False:
            raise AssertionError(f"mesh {name} {n}x{c} unsharded: max_bid "
                                 f"{want[name]['max_bid']}, want "
                                 f"{max(job['bids'])}")
        log(f"[mesh {name} {n}x{c}] unsharded in this process: max_bid="
            f"{want[name]['max_bid']}, wall {want[name]['wall']:.3f} s")
    first, seen = None, set()
    for backend, ranks, names, mesh in meshes:
        results = mesh.results()
        wall = time.perf_counter() - t0
        for r in results:
            for name, got in zip(names, r["runs"]):
                ref = want[name]
                if r["backend"] != backend or got["max_bid"] != ref["max_bid"] \
                        or got["verified"] != ref["verified"] \
                        or got["deciding"] != ref["deciding"] \
                        or not MC.same_board(got["board"], ref["board"]):
                    raise AssertionError(
                        f"mesh {name} {n}x{c}, rank {r['rank']} of {ranks} "
                        f"({r['backend']}): max_bid {got['max_bid']}, "
                        f"deciding {got['deciding']}, not the unsharded "
                        "run's outcome and board")
                # every launch at the unsharded lanes / ranks, but CCS22's
                # evaluator hash: one lane on every rank (its message gathered)
                lanes = {(k, l if (k, l) == (HASH, 1) else l // ranks): v
                         for (k, l), v in ref["launch_lanes"].items()}
                if (any(l % ranks for k, l in ref["launch_lanes"]
                        if (k, l) != (HASH, 1))
                        or got["launch_lanes"] != lanes):
                    raise AssertionError(
                        f"mesh {name} {n}x{c}, rank {r['rank']} of {ranks}: "
                        f"launches {sorted(got['launch_lanes'].items())}, "
                        f"want the unsharded lanes / {ranks} (the evaluator's "
                        f"hash at one lane): "
                        f"{sorted(lanes.items())}")
                seen |= set(got["launch_lanes"])
                log(f"[mesh {name} {n}x{c}] rank {r['rank']} of {ranks} "
                    f"({r['backend']}, {r['info']['platform']}): the "
                    f"unsharded board and max_bid={got['max_bid']}, wall "
                    f"{got['wall']:.3f} s; launches by kernel@lanes "
                    + json.dumps({f"{k}@{l}": v for (k, l), v in
                                  sorted(got["launch_lanes"].items())}))
        log(f"[mesh] {ranks} {backend} rank(s), {', '.join(names)}: "
            f"{wall:.1f} s from the spawn to the last result (the meshes "
            "run at once, beside this process's unsharded runs)")
        if first is None:
            first = {}
            for got in results[0]["runs"]:
                for key, v in got["launch_lanes"].items():
                    first[key] = first.get(key, 0) + v
    return first, seen


class Sweep:
    """tools/run_sweep_torch.py over the first `pairs` pairs of params.txt
    on `device`, in a process of its own that runs beside phases 6 and 6b
    (its log in build/sweep.log); `result()` waits for it and fails unless
    it exits 0 with every pair passed, `stop()` kills it if it still
    runs."""

    def __init__(self, device, pairs=SWEEP_PAIRS):
        import torch

        root = pathlib.Path(__file__).resolve().parent
        params = root / "build" / "sweep_params.txt"
        params.parent.mkdir(exist_ok=True)
        params.write_text("\n".join(
            (root / "params.txt").read_text().splitlines()[:pairs]) + "\n")
        self.argv = ["--params", str(params), "--device",
                     torch.device(device).type]
        self.log_path = root / "build" / "sweep.log"
        self._log = open(self.log_path, "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, str(root / "tools" / "run_sweep_torch.py"),
             *self.argv], stdout=self._log, stderr=subprocess.STDOUT, cwd=root)

    def result(self, timeout=900):
        rc = self.proc.wait(timeout=timeout)
        self._log.close()
        text = self.log_path.read_text()
        for line in text.splitlines():
            log(f"[sweep] {line}")
        if rc != 0 or "# PASS" not in text:
            raise AssertionError(f"tools/run_sweep_torch.py exited with {rc}")
        log(f"[tools] tools/run_sweep_torch.py {' '.join(self.argv)}: exit 0, "
            f"{time.perf_counter() - self.t0:.1f} s from its start (beside "
            "phases 6 and 6b)")

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self._log.close()


def tools_phase(device, auction=TOOLS_AUCTION):
    """The port's tools through their `main`, on `device`: the phase
    profile, the SEAL parts and the hub demo at `auction`; each must exit
    0, and the demo launch no kernel (the sweep: `Sweep`)."""
    import torch

    from privacy_auction_tpu_torch.ops import cuda_ec

    tools = str(pathlib.Path(__file__).resolve().parent / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    n, c = auction
    dev = ["--device", torch.device(device).type]
    for name, argv in (
            ("profile_phases_torch", [str(n), str(c), "--reps", "1"] + dev),
            ("bench_seal_parts_torch", [str(n), str(c)] + dev),
            ("demo_native_board_torch", None)):
        mod = importlib.import_module(name)
        cuda_ec.reset_launches()
        t0 = time.perf_counter()
        rc = mod.main(n, c, SEED) if argv is None else mod.main(argv)
        wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"tools/{name}.py exited with {rc}")
        if argv is None and any(cuda_ec.launches.values()):
            raise AssertionError(f"tools/{name}.py launched kernels")
        log(f"[tools] tools/{name}.py {' '.join(argv or [str(n), str(c)])}: "
            f"exit 0 in {wall:.1f} s")


def p256_phase(n: int, c: int, device):
    """Phase 6b: fused SEAL (verified) and CCS22 auctions on P-256 at n x c
    on `device`; no EC kernel may launch (P-256 runs the generic plain
    path), and SHA-256, which does not depend on the curve, must launch.
    Returns the SHA-256 launches by lane count."""
    import torch

    from privacy_auction_tpu_torch.curves import get_curve
    from privacy_auction_tpu_torch.ops import cuda_ec
    from privacy_auction_tpu_torch.protocols import ccs22, seal

    P256 = get_curve("P-256")
    p_rng = random.Random(SEED + 256)
    cuda_ec.reset_launches()
    bids = [(1 << (c - 1)) | p_rng.randrange(1 << (c - 1)) for _ in range(n)]
    times = {}
    t0 = time.perf_counter()
    res = seal.run_auction(P256, bids, c, verify=True,
                           generator=torch.Generator().manual_seed(SEED + 256),
                           device=device, phase_times=times)
    wall = time.perf_counter() - t0
    if not res.verified or res.max_bid != max(bids):
        raise AssertionError(f"P-256 SEAL {n}x{c}: verified={res.verified} "
                             f"max_bid={res.max_bid} != {max(bids)}")
    log(f"[p256 seal {n}x{c}] verified, max_bid={res.max_bid}, wall {wall:.3f} "
        "s; phases " + ", ".join(f"{k} {v:.3f} s" for k, v in times.items()))
    bids = [p_rng.randrange(1 << c) for _ in range(n)]
    eval_id = p_rng.randrange(n)
    t0 = time.perf_counter()
    ccs22.pp_or_make(P256, device)
    crs = time.perf_counter() - t0
    times = {}
    t0 = time.perf_counter()
    res = ccs22.run_auction(P256, bids, c, eval_id,
                            generator=torch.Generator().manual_seed(SEED + 257),
                            device=device, phase_times=times)
    wall = time.perf_counter() - t0
    if res.max_bid != max(bids):
        raise AssertionError(f"P-256 CCS22 {n}x{c}: max_bid={res.max_bid} != "
                             f"{max(bids)}")
    log(f"[p256 ccs22 {n}x{c}] evaluator {eval_id}, max_bid={res.max_bid}, wall "
        f"{wall:.3f} s (CRS {crs:.3f} s before it); phases "
        + ", ".join(f"{k} {v:.3f} s" for k, v in times.items()))
    ec_rows = [k for k in cuda_ec.EC_ROWS if cuda_ec.launches[k]]
    if ec_rows or not cuda_ec.launches[HASH]:
        raise AssertionError(f"P-256: EC kernels {ec_rows} launched, sha256 "
                             f"{cuda_ec.launches[HASH]} times")
    log("[p256] both auctions ran the generic plain path: no EC kernel "
        f"launched; sha256 {cuda_ec.launches[HASH]} launches, by lanes "
        + json.dumps({f"{k}@{n}": v for (k, n), v in
                      sorted(cuda_ec.launch_lanes.items())}))
    return dict(cuda_ec.launch_lanes)


def sha256_phase(device, lanes=SHA_LANES, lengths=SHA_LENGTHS,
                 chains=SHA_CHAINS, plain_chains=SHA_PLAIN_CHAINS):
    """Phase 3b: the SHA-256 kernel against its plain version on `device`
    and against hashlib, exactly, for every message length of `lengths` at
    each lane count of `lanes` (one input set a length, at the most lanes;
    the kernel on its first l lanes), and for the one-lane messages of
    `chains` (CCS22's evaluator message at each (n, c)); the plain version
    runs on those of `plain_chains` only.  Each case is timed after its
    checked launch: the kernel with CUDA events around 5 launches (which
    hold the wrapper's host time), the plain version once.  Returns
    the kernels line's rows (without the launches, which phase 8 adds) and
    the clocks of a round's critical chain on this card."""
    import hashlib

    import torch

    from privacy_auction_tpu_torch.ops import cuda_ec
    from privacy_auction_tpu_torch.ops.sha256 import sha256_plain

    def words(msg) -> list:
        return [int.from_bytes(hashlib.sha256(bytes(m)).digest()[4 * i:4 * i + 4],
                               "big") for m in msg for i in range(8)]

    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def timed(fn, reps):
        e0.record()
        for _ in range(reps):
            out = fn()
        e1.record()
        torch.cuda.synchronize()
        return out, e0.elapsed_time(e1) / reps

    gen = torch.Generator().manual_seed(SEED + 3)
    cases = [(length, lanes) for length in lengths]
    cases += [(4 * c * 32 + n * c * 32, (1,)) for n, c in chains]
    rows = []
    for length, counts in cases:
        host = torch.randint(0, 256, (max(counts), length), generator=gen,
                             dtype=torch.uint8)
        want = torch.tensor(words(host.numpy()), dtype=torch.int64).reshape(-1, 8)
        msg = host.to(device)
        one = counts == (1,)
        run_plain = not one or any(4 * c * 32 + n * c * 32 == length
                                   for n, c in plain_chains)
        for n in counts:
            got = cuda_ec.sha256(msg[:n])
            if not torch.equal(got.cpu(), want[:n]):
                raise AssertionError(f"sha256 at {n} lanes of {length} B: the "
                                     "kernel differs from hashlib")
            _, ms = timed(lambda: cuda_ec.sha256(msg[:n]), 5)
            plain_ms = None
            if run_plain:
                plain, plain_ms = timed(lambda: sha256_plain(msg[:n]), 1)
                if not torch.equal(plain, got):
                    raise AssertionError(f"sha256 at {n} lanes of {length} B: "
                                         "the kernel differs from the plain "
                                         "version")
            blocks = cuda_ec.sha256_blocks(length)
            rows.append({"lanes": n, "bytes": length, "blocks": blocks,
                         "ms": ms, "plain_ms": plain_ms})
            log(f"[sha256] {n} lanes of {length} B ({blocks} blocks): equal to "
                + ("the plain version and " if run_plain else "")
                + f"hashlib; kernel {ms:.4f} ms"
                + (f", plain {plain_ms:.1f} ms" if run_plain else
                   " (the plain version not run: one eager chain of "
                   f"{blocks} blocks)"))
    clocks = cuda_ec.sha256_chain_clocks(device)
    log(f"[sha256] {len(rows)} cases equal to hashlib, "
        f"{sum(r['plain_ms'] is not None for r in rows)} to the plain version "
        f"too; a round's critical chain (Sigma1, then the add that makes the "
        f"new e) takes {clocks:.2f} clocks on one thread")
    return rows, clocks


def sha256_bound(lanes: int, length: int, chain_clocks: float) -> dict:
    """The least time of one SHA-256 launch over `lanes` messages of
    `length` bytes: the larger of its 32-bit integer operations over the
    card's rate, its bytes (each message read once, each digest written
    once) over the memory rate, and one lane's chain of rounds (blocks x 64
    rounds x a round's critical chain) at the boost clock."""
    from privacy_auction_tpu_torch.ops import cuda_ec

    blocks = cuda_ec.sha256_blocks(length)
    ops_s = lanes * blocks * cuda_ec.SHA256_OPS_PER_BLOCK / INT_OP_RATE
    bytes_s = lanes * (length + 64) / HBM_RATE
    chain_s = blocks * 64 * chain_clocks / BOOST_CLOCK
    return {"bound_ms": 1e3 * max(ops_s, bytes_s, chain_s),
            "bound_by": "bytes" if bytes_s > max(ops_s, chain_s) else "operations",
            "bound_ops_ms": 1e3 * ops_s, "bound_bytes_ms": 1e3 * bytes_s,
            "bound_chain_ms": 1e3 * chain_s}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    from privacy_auction_tpu_torch.curves import (COMB_WINDOWS, GLV_WINDOWS,
                                                  SECP256K1 as C)
    from privacy_auction_tpu_torch.nizk import PoKDLog
    from privacy_auction_tpu_torch.ops import cuda_ec, ec
    from privacy_auction_tpu_torch.ops import field as F
    from privacy_auction_tpu_torch.ops.validate import validate_kernels
    from privacy_auction_tpu_torch import cli
    from privacy_auction_tpu_torch.protocols import ccs22, seal
    from privacy_auction_tpu_torch.utils import trackers as T

    dev = torch.device(DEVICE, 0)
    host = C.host

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
    # every variant with a table: the group kernels at each G they are
    # built for
    variants = {f"{k}<{g}>" for k in cuda_ec.SELECT_KERNELS
                for g in cuda_ec.GROUPS[k]}
    unchecked = variants - {r["variant"] for r in selects}
    bad = [f"{r['variant']}:{r['select']}" for r in selects if not r["ok"]]
    if len(variants) < SELECT_VARIANTS or unchecked or bad:
        raise AssertionError(f"selects: {len(variants)} kernel variants with "
                             f"tables, {SELECT_VARIANTS} expected; "
                             f"{sorted(unchecked)} not found in the SASS, "
                             f"{bad} missing or not constant-time as compiled")
    log(f"[sass] {len(selects)} selects checked, one in each of "
        f"{len(variants)} kernel variants: all constant-time")

    # ---- 2c. the hub auction: one party process a bidder, all on the card --------
    hub_launches, hub_lanes = hub_phase(*HUB, DEVICE, MemorySampler)

    # ---- 2d. the bidder mesh: spawned ranks, gloo and NCCL -------------------
    mesh_lanes, mesh_seen = mesh_phase(*MESH, DEVICE)

    # ---- 3. validator (this slice's path) and parity ---------------------------
    cuda_ec.reset_launches()
    validate_kernels(C, lanes=8, seed=SEED, device=dev)
    torch.cuda.synchronize()
    validator_launches = dict(cuda_ec.launches)
    validator_lanes = dict(cuda_ec.launch_lanes)
    # every EC kernel; the validator does not hash
    idle = [k for k in cuda_ec.EC_ROWS if validator_launches[k] == 0]
    if idle or validator_launches[HASH]:
        raise AssertionError(f"validator: kernels {idle} never launched, "
                             f"sha256 {validator_launches[HASH]} times")
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
        """(inputs, kernel call, plain call, host oracle for lane i) on
        random data over `lanes` lanes: the inputs are lane-major tensors,
        the calls take them (or their first l lanes, each lane being
        computed on its own) and the kernel call a launch shape too
        (`shape=None`: launch_shape's).  The GLV kernels get 132-bit
        scalars, as the split gives them, the 64-window ladders full
        scalars."""
        if name == "mul_comb":
            ks, k = scalars(lanes)
            table = C.tensor("comb_table", dev)
            return ([k],
                    lambda k, shape=None: cuda_ec.mul_comb(C, table, k, shape),
                    lambda k: ec.mul_comb_plain(C, table, k),
                    lambda i: host.mul(ks[i], host.g))
        if name == "pt_add":
            (_, P), (_, Q) = points(lanes), points(lanes)
            if lanes >= 5:
                # the validator's special lanes: P + P, P + (-P), P + inf,
                # inf + Q
                Q[1] = P[1]
                Q[2] = ec.neg(C, P[2])
                Q[3] = ec.infinity(dev)
                P[4] = ec.infinity(dev)
            return ([P, Q],
                    lambda P, Q, shape=None: cuda_ec.pt_add(C, P, Q, shape),
                    lambda P, Q: ec.add(C, P, Q),
                    lambda i: host.add(ec.decode_host_point(C, P[i]),
                                       ec.decode_host_point(C, Q[i])))
        if name in ("scalar_mul", "base_mul_add", "dual_mul_64"):
            (a, P), (b, Q) = points(lanes), points(lanes)
            (ss, s), (ts, t) = scalars(lanes), scalars(lanes)
            if name == "scalar_mul":
                return ([P, s],
                        lambda P, s, shape=None: cuda_ec.scalar_mul(
                            C, P, s, shape=shape),
                        lambda P, s: ec.scalar_mul_windows_plain(C, P, s),
                        lambda i: host.mul(a[i] * ss[i], host.g))
            if name == "base_mul_add":
                g0b = C.tensor("g0_table", dev)
                return ([s, P, t],
                        lambda s, P, t, shape=None: cuda_ec.base_mul_add(
                            C, s, P, t, g0b, shape),
                        lambda s, P, t: ec.base_mul_add_plain(C, s, P, t),
                        lambda i: host.mul(ss[i] + a[i] * ts[i], host.g))
            return ([P, s, Q, t],
                    lambda *x, shape=None: cuda_ec.dual_mul(
                        C, *x, COMB_WINDOWS, shape),
                    lambda *x: ec.dual_mul_windows_plain(C, *x, COMB_WINDOWS),
                    lambda i: host.mul(a[i] * ss[i] + b[i] * ts[i], host.g))
        nsrc = {"dual_mul": 2, "quad_mul": 4, "base_mul_add_glv": 2}[name]
        srcs = [points(lanes) + scalars(lanes, 132) for _ in range(nsrc)]
        args = [t for a, P, s, k in srcs for t in (P, k)]

        def ladder_want(i):
            return host.mul(sum(a[i] * s[i] for a, _, s, _ in srcs), host.g)
        if name == "dual_mul":
            return (args,
                    lambda *x, shape=None: cuda_ec.dual_mul(
                        C, *x, GLV_WINDOWS, shape),
                    lambda *x: ec.dual_mul_windows_plain(C, *x, GLV_WINDOWS),
                    ladder_want)
        if name == "quad_mul":
            return (args,
                    lambda *x, shape=None: cuda_ec.quad_mul(
                        C, *x, GLV_WINDOWS, shape),
                    lambda *x: ec.quad_mul_windows_plain(C, *x, GLV_WINDOWS),
                    ladder_want)
        ss1, s1 = scalars(lanes, 132)
        ss2, s2 = scalars(lanes, 132)
        flags = torch.randint(0, 2, (lanes, 2), generator=gen).to(dev)
        fl = flags.cpu().tolist()
        lam = C.glv.lam
        g0 = C.tensor("g0_tables", dev)

        def want(i):
            e = ((-1) ** fl[i][0] * ss1[i] + (-1) ** fl[i][1] * ss2[i] * lam
                 + sum(a[i] * s[i] for a, _, s, _ in srcs))
            return host.mul(e % host.n, host.g)
        return (args + [s1, s2, flags],
                lambda *x, shape=None: cuda_ec.base_mul_add_glv(
                    C, *x, g0, GLV_WINDOWS, shape),
                lambda *x: ec.base_mul_add_glv_plain(C, *x, GLV_WINDOWS),
                want)

    # the timed rows (phase 8): each row at a shape the 128x8 auction gives
    # it, the group rows at the other paths' shapes, the mesh ranks' too
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
    timed = [(name, shapes[name], False) for name in ROWS]
    timed += [(name, lanes, True) for name, lanes in GROUP_TIMED]
    # and the lane counts of the hub's parties and the mesh's ranks
    timed += [(name, lanes, True)
              for name, lanes in sorted(set(hub_lanes) | set(mesh_lanes))
              if name in ROWS and (name, lanes) not in GROUP_TIMED
              and (name, lanes) != (name, shapes.get(name))]
    timing = {}

    # each row at every lane count against its plain version: one input
    # set a row, at its most lanes, one plain run over it (each lane is
    # computed on its own, so its first l lanes are the reference at l
    # lanes), the kernel on the first l lanes at each G; the timed rows
    # timed on those inputs, the plain version too (launch_shape's G)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    reps = 5
    n_cases = 0
    for name in ROWS:
        kernel = name.removesuffix("_64")
        counts = sorted(set(RAGGED_LANES + AUCTION_LANES[name])
                        | {n for k, n in hub_lanes if k == name}
                        | {n for k, n in mesh_seen if k == name}
                        | {n for k, n, _ in timed if k == name})
        xs, run_k, run_p, want = kernel_inputs(name, counts[-1])
        ref_all = run_p(*xs)
        for lanes in counts:
            cut = [x[:lanes] for x in xs]
            outs = {g: run_k(*cut, shape=cuda_ec.launch_shape(kernel, lanes,
                                                              group=g))
                    for g in cuda_ec.GROUPS[kernel]}
            ref = ref_all[:lanes]
            torch.cuda.synchronize()
            for g, got in outs.items():
                if not torch.equal(got, ref):
                    bad = int((got != ref).any(-1).any(-1).sum())
                    raise AssertionError(f"{name} ({g} threads a lane): {bad} "
                                         f"of {lanes} lanes differ from the "
                                         "plain version")
            sampled = rng.sample(range(lanes), min(SAMPLED, lanes))
            if name == "pt_add":
                sampled = sorted(set(sampled) | set(range(min(5, lanes))))
            for i in sampled:
                if ec.decode_host_point(C, ref[i]) != want(i):
                    raise AssertionError(f"{name}: lane {i} disagrees with "
                                         "host_curve")
            n_cases += 1
            log(f"[parity] {name}: {lanes} lanes equal the plain version with "
                f"{' and '.join(map(str, outs))} threads a lane, "
                f"{len(sampled)} sampled lanes equal host_curve")
            if any(k == name and n == lanes for k, n, _ in timed):
                e0.record()
                for _ in range(reps):
                    got = run_k(*cut)
                e1.record()
                torch.cuda.synchronize()
                ms = e0.elapsed_time(e1) / reps
                e0.record()
                plain = run_p(*cut)
                e1.record()
                torch.cuda.synchronize()
                timing[(name, lanes)] = {
                    "ms": ms, "plain_ms": e0.elapsed_time(e1),
                    "max_abs_err": max(int((got - ref).abs().max()),
                                       int((plain - ref).abs().max()))}
    log(f"[parity] {n_cases} cases, each equal to its plain version")

    # ---- 3b. the SHA-256 kernel against its plain version and hashlib --------
    sha_rows, chain_clocks = sha256_phase(dev)

    def by_lanes(counts):
        return {f"{k}@{n}": v for (k, n), v in sorted(counts.items())}

    # ---- 4. verified auctions (the main path), their steps on CUDA graphs -------
    auction_launches = {}
    auction_lanes = {}
    fused_runs = {}
    for n, c in AUCTIONS:
        bids = [rng.randrange(1 << c) for _ in range(n)]
        times = {}
        cuda_ec.reset_launches()
        t0 = time.perf_counter()
        res = seal.run_auction(C, bids, c, verify=True,
                               generator=torch.Generator().manual_seed(SEED + n),
                               device=dev, phase_times=times)
        wall = time.perf_counter() - t0
        counts = dict(cuda_ec.launches)
        graphs = dict(seal.last_graphs)
        fused_runs[(n, c)] = (bids, res, wall, times)
        if not res.verified or res.max_bid != max(bids):
            raise AssertionError(f"SEAL {n}x{c}: verified={res.verified} "
                                 f"max_bid={res.max_bid} != {max(bids)}")
        idle = [k for k in SEAL_PATH if counts[k] == 0]
        if idle:
            raise AssertionError(f"SEAL {n}x{c}: kernels {idle} never launched")
        # the step's hashes are single launches: with the eager SHA-256
        # (some 3,000 ops a block) the Stage1 graph held 141,739 kernel
        # nodes at 20x32
        if (n, c) == AUCTIONS[0] and graphs["stage1"]["kernels"] >= 70000:
            raise AssertionError(f"SEAL {n}x{c}: the Stage1 graph has "
                                 f"{graphs['stage1']['kernels']} kernel nodes")
        bits = res.deciding_bits.tolist()
        first = bits.index(1) if 1 in bits else c - 1
        want = {"stage1": first + 1}
        if first < c - 1:
            want["stage2"] = c - 1 - first
        if {k: g["replays"] for k, g in graphs.items()} != want:
            raise AssertionError(
                f"SEAL {n}x{c}: graph replays "
                f"{ {k: g['replays'] for k, g in graphs.items()} }, want "
                f"{want} (deciding bits {bits}): one capture a stage reached, "
                "every step of the stage a replay")
        want_lanes = seal_lanes(n, c, bits)
        if cuda_ec.launch_lanes != want_lanes:
            raise AssertionError(
                f"SEAL {n}x{c}: launches {by_lanes(cuda_ec.launch_lanes)}, "
                f"want the fused driver's {by_lanes(want_lanes)}")
        auction_launches[(n, c)] = counts
        auction_lanes[(n, c)] = dict(cuda_ec.launch_lanes)
        log(f"[seal {n}x{c}] verified, max_bid={res.max_bid}, wall {wall:.3f} s; "
            "phases " + ", ".join(f"{k} {v:.3f} s" for k, v in times.items()))
        for stage, g in graphs.items():
            log(f"[seal {n}x{c}] {stage} graph: {g['kernels']} GPU kernels a "
                f"step (kernel nodes); warm-up step {g['warmup_s']:.3f} s, "
                f"capture {g['capture_s']:.3f} s, instantiate "
                f"{g['instantiate_s']:.3f} s, {g['replays']} replays "
                f"{g['replay_s']:.3f} s ({g['replay_s'] / g['replays']:.4f} s "
                f"each, with the flag read); its pool took "
                f"{g['memory_bytes'] / 2**20:.1f} MiB of device memory; a "
                f"replay's launches {json.dumps(by_lanes(g['launches']))}")
        log(f"[seal {n}x{c}] launches {json.dumps(counts)}")
        log(f"[seal {n}x{c}] launches by kernel@lanes "
            f"{json.dumps(by_lanes(cuda_ec.launch_lanes))} = the fused "
            "driver's (quad_mul and sha256 twice a step, the commitment's "
            "twice)")

    # ---- 4a. the graphs' board against the role-metered driver's ------------------
    n, c = AUCTIONS[0]
    bids, fused, fused_wall, fused_times = fused_runs[(n, c)]
    times = {}
    t0 = time.perf_counter()
    res = seal.run_auction(C, bids, c, verify=True,
                           generator=torch.Generator().manual_seed(SEED + n),
                           device=dev, phase_times=times, times=T.TimeTracker())
    wall = time.perf_counter() - t0
    diff = board_diff(fused.board, res.board)
    if (not res.verified or res.max_bid != fused.max_bid
            or res.deciding_bits.tolist() != fused.deciding_bits.tolist()
            or diff):
        raise AssertionError(
            f"SEAL {n}x{c}: the metered driver gave verified={res.verified}, "
            f"max_bid={res.max_bid}, deciding {res.deciding_bits.tolist()}; "
            f"the graphs {fused.max_bid}, {fused.deciding_bits.tolist()}; "
            f"boards differ at {diff}")
    log(f"[seal {n}x{c}] the role-metered driver from the same seed: verified, "
        f"max_bid={res.max_bid}, the same deciding bits and board, limb for "
        f"limb; wall {wall:.3f} s against the graphs' {fused_wall:.3f} s "
        f"(steps {fused_times['steps']:.3f} s); metered phases "
        + ", ".join(f"{k} {v:.3f} s" for k, v in times.items()))

    # ---- 4b. the role-metered SEAL auction, through the CLI ----------------------
    n, c = SEAL_METERED
    cuda_ec.reset_launches()
    t0 = time.perf_counter()
    rc = cli.run_seal(n, c, SEED, verify=True, device=DEVICE, warmup=False)
    wall = time.perf_counter() - t0
    counts = dict(cuda_ec.launches)
    idle = [k for k in SEAL_PATH if counts[k] == 0]
    if rc != 0 or idle:
        raise AssertionError(f"metered SEAL {n}x{c}: exit code {rc} (0: "
                             f"verified, the plaintext maximum); kernels {idle} "
                             "never launched")
    metered_launches = {"seal": counts}
    metered_lanes = {"seal": dict(cuda_ec.launch_lanes)}
    log(f"[seal metered {n}x{c}] verified, the plaintext maximum, wall "
        f"{wall:.3f} s; launches {json.dumps(counts)}")
    log(f"[seal metered {n}x{c}] launches by kernel@lanes "
        f"{json.dumps(by_lanes(cuda_ec.launch_lanes))}")

    # ---- 5. CCS22 auctions ---------------------------------------------------------
    ccs22_launches = {}
    ccs22_lanes = {}
    ccs22_runs = {}
    for n, c in CCS22_AUCTIONS:
        bids = [rng.randrange(1 << c) for _ in range(n)]
        eval_id = rng.randrange(n)
        times = {}
        ccs22.pp_or_make(C, dev)          # the CRS: host hash-to-curve, once
        cuda_ec.reset_launches()
        t0 = time.perf_counter()
        res = ccs22.run_auction(C, bids, c, eval_id,
                                generator=torch.Generator().manual_seed(SEED + n),
                                device=dev, phase_times=times)
        ccs22_runs[(n, c)] = (bids, eval_id, res.board)
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
        ccs22_lanes[(n, c)] = dict(cuda_ec.launch_lanes)
        log(f"[ccs22 {n}x{c}] evaluator {eval_id}, max_bid={res.max_bid}, wall "
            f"{wall:.3f} s; phases " + ", ".join(f"{k} {v:.3f} s"
                                                 for k, v in times.items()))
        log(f"[ccs22 {n}x{c}] launches {json.dumps(counts)}")
        log(f"[ccs22 {n}x{c}] launches by kernel@lanes "
            f"{json.dumps(by_lanes(cuda_ec.launch_lanes))}")
        graph = dict(ccs22.last_graph)
        if graph.get("replays") != c:
            raise AssertionError(f"CCS22 {n}x{c}: {graph.get('replays')} "
                                 f"replays of the step graph, want {c}")
        log(f"[ccs22 {n}x{c}] step graph: {graph['kernels']} GPU kernels a "
            f"step (kernel nodes); warm-up step {graph['warmup_s']:.3f} s, "
            f"capture {graph['capture_s']:.3f} s, instantiate "
            f"{graph['instantiate_s']:.3f} s, {c} replays "
            f"{graph['replay_s']:.3f} s ({graph['replay_s'] / c:.5f} s each, "
            f"one synchronization after the last); its pool took "
            f"{graph['memory_bytes'] / 2**20:.1f} MiB of device memory; a "
            f"replay's launches {json.dumps(by_lanes(graph['launches']))}")
        if (n, c) == CCS22_AUCTIONS[0]:
            # the steps once more, uncaptured, from the same draws, with
            # every host synchronization an error: nothing is read back
            # between steps, and the board is the graph's, limb for limb
            pp = ccs22.pp_or_make(C, dev)
            draws = ccs22.draw(C, torch.Generator().manual_seed(SEED + n), n,
                               c, dev)
            pre = ccs22._precompute(C, pp, res.board.setup.X, draws)
            bits = torch.as_tensor(seal.bids_to_bits(bids, c), device=dev)
            eid = ccs22.eval_index(eval_id, dev)
            g1n = pp.g1.expand(n, 3, F.LIMBS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                eager = ccs22._scan_steps(C, pre, g1n, bits, eid, graph=False)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            eager_s = time.perf_counter() - t0
            diff = board_diff(eager, (res.board.announced, res.board.otr1,
                                      res.board.ots), "steps")
            if diff:
                raise AssertionError(f"CCS22 {n}x{c}: the uncaptured steps "
                                     f"differ from the graph's at {diff}")
            log(f"[ccs22 {n}x{c}] the {c} steps uncaptured ran with host syncs "
                "made errors (none occurred) and gave the graph's announced "
                f"bits and OT messages, limb for limb, in {eager_s:.3f} s "
                f"(the graph's replays {graph['replay_s']:.3f} s)")

    # ---- 5b. the role-metered CCS22 auction, from the fused run's draws ------------
    n, c = METERED
    bids, eval_id, fused_board = ccs22_runs[METERED]
    draws = ccs22.draw(C, torch.Generator().manual_seed(SEED + n), n, c, dev)
    data, role_times, phase_times = T.DataTracker(), T.TimeTracker(), {}
    comm = T.Ccs22CommTracker(data)
    comm.account_setup(n, c)
    cuda_ec.reset_launches()
    t0 = time.perf_counter()
    res = ccs22.run_auction(C, bids, c, eval_id, device=dev, draws=draws,
                            phase_times=phase_times, times=role_times,
                            trackers=comm)
    wall = time.perf_counter() - t0
    counts = dict(cuda_ec.launches)
    metered_launches["ccs22"] = counts
    metered_lanes["ccs22"] = dict(cuda_ec.launch_lanes)
    cli.ccs22_report(n, c, eval_id, DEVICE, role_times, data, phase_times,
                     wall)
    idle = [k for k in CCS22_KERNELS if counts[k] == 0]
    stray = [k for k, v in counts.items() if v and k not in CCS22_KERNELS]
    if res.max_bid != max(bids) or idle or stray:
        raise AssertionError(f"metered CCS22 {n}x{c}: max_bid={res.max_bid} "
                             f"!= {max(bids)}, kernels {idle} never launched, "
                             f"{stray} launched")
    differ = [] if torch.equal(res.board.announced, fused_board.announced) \
        else ["announced"]
    for part in ("setup", "otr1", "ots"):
        for name, a, b in zip(getattr(fused_board, part)._fields,
                              getattr(fused_board, part),
                              getattr(res.board, part)):
            if name in ("G", "H", "C0", "C1"):
                a, b = (ec.serialize_uncompressed(C, x) for x in (a, b))
            if not torch.equal(a, b):
                differ.append(f"{part}.{name}")
    if differ:
        raise AssertionError(f"metered CCS22 {n}x{c}: board fields {differ} "
                             "differ from the fused run's")
    log(f"[ccs22 metered {n}x{c}] evaluator {eval_id}, max_bid={res.max_bid}, "
        f"the fused run's board, wall {wall:.3f} s; launches "
        f"{json.dumps(counts)}")
    log(f"[ccs22 metered {n}x{c}] launches by kernel@lanes "
        f"{json.dumps(by_lanes(cuda_ec.launch_lanes))}")

    # ---- 6-6b run beside the sweep of the tools phase (a process of its own)
    sweep = Sweep(DEVICE)
    try:
        # ---- 6. a tampered PoKDLog is rejected ------------------------------------
        n_t = 8
        ids = torch.arange(n_t, device=dev)
        pub, _ = seal.round_one_batch(
            C, torch.Generator().manual_seed(SEED), n_t, 1, ids)
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

        # the metered loop's honest control and tamper cases, against the JAX
        # package's golden vectors
        import pytest
        M = _tests_module("torch_metered_cases")

        t0 = time.perf_counter()
        with pytest.MonkeyPatch.context() as mp:
            M.check_honest(mp, DEVICE)
        log(f"[tamper] the honest control at {M.SEAL_BIDS}, c = {M.SEAL_C} "
            "verifies and matches the JAX package's deciding bits, bytes, hook "
            f"calls and checks ({time.perf_counter() - t0:.3f} s)")
        for case in M.TAMPER_CASES:
            t0 = time.perf_counter()
            with pytest.MonkeyPatch.context() as mp:
                checks = M.check_tamper(case, mp, DEVICE)
            name, step, _ = checks[-1]
            log(f"[tamper] {case}: verified=False, max_bid=-1 at "
                f"{M.CHECKS[name]} (step {step}), as the JAX package "
                f"({time.perf_counter() - t0:.3f} s)")

        # ---- 6b. P-256 on the generic plain path ----------------------------------
        p256_lanes = p256_phase(*P256_AUCTION, dev)

        sweep.result()
    finally:
        sweep.stop()

    # ---- 7. the ladder bench ------------------------------------------------------
    spec = importlib.util.spec_from_file_location(
        "bench_ladder_torch",
        pathlib.Path(__file__).resolve().parent / "tools" / "bench_ladder_torch.py")
    bench_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench_mod)
    log("[bench] tools/bench_ladder_torch.py --lanes "
        f"{BENCH_LANES}: {json.dumps(bench_mod.bench([BENCH_LANES], device=dev)[0])}")
    tools_phase(DEVICE)

    # ---- 8. the kernels line: phase 3's times beside each row's bound ---------------
    report = []
    for name, lanes, extra in timed:
        t = timing[(name, lanes)]
        if t["max_abs_err"]:
            raise AssertionError(f"{name}: kernel and plain differ at {lanes} lanes")
        ops_s = cuda_ec.int_muls(name.removesuffix("_64"), lanes,
                                 windows.get(name, GLV_WINDOWS)) / INT_MUL_RATE
        bytes_s = (lanes * bytes_per_lane[name]
                   + table_bytes.get(name, 0)) / HBM_RATE
        path = ("seal 20x32" if name in SEAL_KERNELS else "validator")
        kernel = name.removesuffix("_64")
        shape = cuda_ec.launch_shape(kernel, lanes)
        row = f"{kernel}<{shape[0]}>"
        report.append({
            "name": f"{name}@{lanes}" if extra else name, "route": "cuda",
            "source": SOURCE if name == "pt_add" else GROUP_SOURCE,
            "replaces": REPLACES[name],
            "launches": ((auction_lanes[AUCTIONS[0]] if name in SEAL_KERNELS
                          else validator_lanes).get((name, lanes), 0) if extra
                         else auction_launches[AUCTIONS[0]][name]
                         if name in SEAL_KERNELS else validator_launches[name]),
            "launches_path": path,
            f"launches_seal_{AUCTIONS[-1][0]}x{AUCTIONS[-1][1]}": (
                auction_lanes[AUCTIONS[-1]].get((name, lanes), 0) if extra
                else auction_launches[AUCTIONS[-1]][name]),
            **{f"launches_ccs22_{a}x{b}": (
                ccs22_lanes[(a, b)].get((name, lanes), 0) if extra
                else ccs22_launches[(a, b)][name]) for a, b in CCS22_AUCTIONS},
            **{f"launches_{p}_metered_{a}x{b}": (
                metered_lanes[p].get((name, lanes), 0) if extra
                else metered_launches[p][name])
               for p, (a, b) in (("seal", SEAL_METERED), ("ccs22", METERED))},
            f"launches_hub_{HUB[0]}x{HUB[1]}": (
                hub_lanes.get((name, lanes), 0) if extra
                else hub_launches[name]),
            f"launches_mesh_{MESH[0]}x{MESH[1]}": (
                mesh_lanes.get((name, lanes), 0) if extra
                else sum(v for (k, _), v in mesh_lanes.items() if k == name)),
            "launches_validator": validator_launches[name],
            "lanes": lanes, "windows": windows.get(name),
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": 1e3 * max(ops_s, bytes_s),
            "bound_by": "operations" if ops_s >= bytes_s else "bytes",
            "library_ms": None,
            **resources.get(row, {}),
            "threads_a_lane": shape[0], "threads_a_block": shape[2],
            "smem_bytes": shape[3],
        })
        log(f"[time] {name} at {lanes} lanes: kernel {t['ms']:.3f} ms, plain "
            f"{t['plain_ms']:.1f} ms, bound {1e3 * max(ops_s, bytes_s):.4f} ms")

    # the SHA-256 rows: phase 3b's cases; launches by lane count (any
    # message length) on each path, the main row's (20 lanes of a Stage1
    # transcript, a SEAL 20x32 step's) all of the path's
    paths = {f"launches_seal_{AUCTIONS[-1][0]}x{AUCTIONS[-1][1]}":
             auction_lanes[AUCTIONS[-1]],
             **{f"launches_ccs22_{a}x{b}": ccs22_lanes[(a, b)]
                for a, b in CCS22_AUCTIONS},
             f"launches_seal_metered_{SEAL_METERED[0]}x{SEAL_METERED[1]}":
             metered_lanes["seal"],
             f"launches_ccs22_metered_{METERED[0]}x{METERED[1]}":
             metered_lanes["ccs22"],
             f"launches_hub_{HUB[0]}x{HUB[1]}": hub_lanes,
             f"launches_mesh_{MESH[0]}x{MESH[1]}": mesh_lanes,
             f"launches_p256_{P256_AUCTION[0]}x{P256_AUCTION[1]}": p256_lanes}
    main_lanes = auction_lanes[AUCTIONS[0]]
    sha_res = resources.get(HASH, {})
    for r in sha_rows:
        main = (r["lanes"], r["bytes"]) == (AUCTIONS[0][0], 1066)

        def count(lanes_by_key, main=main, lanes=r["lanes"]):
            return sum(v for (k, l), v in lanes_by_key.items()
                       if k == HASH and (main or l == lanes))
        bound = sha256_bound(r["lanes"], r["bytes"], chain_clocks)
        report.append({
            "name": HASH if main else f"{HASH}@{r['lanes']}x{r['bytes']}B",
            "route": "cuda", "source": SHA_SOURCE, "replaces": SHA_REPLACES,
            "launches": count(main_lanes), "launches_path": "seal 20x32",
            **{k: count(v) for k, v in paths.items()},
            "launches_validator": validator_launches[HASH],
            "lanes": r["lanes"], "bytes": r["bytes"], "blocks": r["blocks"],
            "max_abs_err": 0, "ms": r["ms"], "plain_ms": r["plain_ms"],
            **bound, "library_ms": None,
            "chain_clocks_a_round": chain_clocks, **sha_res,
            "threads_a_block": cuda_ec.SHA256_THREADS})
        log(f"[time] sha256 at {r['lanes']} lanes of {r['bytes']} B: kernel "
            f"{r['ms']:.4f} ms, plain "
            + (f"{r['plain_ms']:.1f} ms" if r["plain_ms"] is not None
               else "not run")
            + f", bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}; "
            f"chain {bound['bound_chain_ms']:.4f} ms)")

    log(f"[done] total {time.perf_counter() - _T0:.1f} s")
    print(json.dumps({"kernels": report}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
