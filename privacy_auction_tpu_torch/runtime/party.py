"""Multi-process VERIFIED SEAL auction over the native socket hub, in
PyTorch.

Counterpart of `privacy_auction_tpu/runtime/party.py`, the deployment
topology: every bidder is an OS process that runs the batched SEAL phases
for its own lane -- commit, per-step keys, round-two ciphertext and Stage1
or Stage2 proof -- and the full batched verifier over everyone's published
proofs, with messages exchanged through the C++ bulletin-board hub
(`native/pa_runtime.cc`) in the reference's wire format (65 B a point, 32 B
a scalar, `runtime/wire.py`).  The hub's byte meters therefore measure a
verified auction's real traffic.

The phase loop mirrors the reference's round trips (`SEAL/main.cpp:46-120`)
and the JAX driver call for call: post commit -> fetch all + verify -> per
step: post round one -> fetch all + verify -> post round two -> fetch all
+ verify -> veto sum.  Blocking fetches are the phase barriers.  Meter
categories: uploads "bidder", each party's downloads of the n messages
"verifier" (n parties x n messages, the reference's n^2 fan-out), results
"result" (each party posts 9 bytes, the driver fetches each once).

The hub is a process of its own (`serve_hub`), which the driver kills at
the end; the driver reads results and meters through a client.

Device: every party runs on `device` ("cuda" unless the caller asks for
the CPU): one GPU holds n processes, each with its own CUDA context, and a
party never moves to the CPU because CUDA is missing.  The parent builds
and loads the native hub and the EC kernels before it spawns (`warm_build`),
so the n children only load them.  Children are spawned, never forked.

Randomness: party i draws from its own `torch.Generator` on its device,
seeded with seed * 1_000_003 + i (the JAX driver's key formula), in a fixed
order: the commit's scalars and proof nonces, then per step the round-one
keys with their proof nonces (`seal.draw_round_one`), then that step's
round-two proof nonces.  A hub run repeats from its seed on one device.

Usage: python -m privacy_auction_tpu_torch.runtime.party [n] [c] [seed]
       [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import shutil
import sys
import tempfile
import time

PHASE_COMMIT = 0
PHASE_ROUND1 = 1
PHASE_ROUND2 = 2
PHASE_RESULT = 7
RESULT_BYTES = 9          # 8 bytes of max bid, 1 byte of ok
SEED_STRIDE = 1_000_003   # party i's seed: seed * SEED_STRIDE + i
POLL_S = 0.05             # how often the driver looks at results and children


def _tree_concat(msgs):
    """The n one-lane messages of `msgs` concatenated along axis 0."""
    import torch

    first = msgs[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.cat(msgs, dim=0)
    return type(first)(*(_tree_concat(list(f)) for f in zip(*msgs)))


def _tree_to(tree, device):
    import torch

    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return type(tree)(*(_tree_to(t, device) for t in tree))


def _report_path(report_dir: str, pid: int) -> str:
    return os.path.join(report_dir, f"party_{pid}.json")


def run_party(sock_path: str, pid: int, n: int, c: int, bid: int, seed: int,
              timeout_s: float = 600.0, device="cuda",
              report_dir: str | None = None) -> None:
    """One bidder process: generate with its own lane, verify everyone.
    Writes a report (pid, device, seconds, kernel launches by kernel and by
    lane count) to `report_dir`, if given, before it posts its result."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"party {pid}: device {device} asked for, but CUDA "
                           "is not available")
    # n parties share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))

    from ..curves import SECP256K1 as CURVE
    from ..ops import cuda_ec
    from ..protocols import seal
    from . import wire
    from .native import BoardClient

    t0 = time.perf_counter()
    cuda_ec.reset_launches()
    cl = BoardClient(sock_path, connect_timeout_s=timeout_s)
    gen = torch.Generator(device=dev).manual_seed(seed * SEED_STRIDE + pid)
    bits1 = torch.as_tensor(seal.bids_to_bits([bid], c), device=dev)  # (1, c)
    ids1 = torch.tensor([pid], device=dev)
    ids_all = torch.arange(n, device=dev)

    def fetch_all(phase, rnd, template):
        msgs = [wire.unpack(CURVE, template,
                            cl.fetch_wait(phase, rnd, j, "verifier", timeout_s),
                            device="cpu")
                for j in range(n)]
        return _tree_to(_tree_concat(msgs), dev)

    ok = True
    # ---- commit phase (`SEAL/main.cpp:46-59`) ----
    cpub, csec = seal.commit(CURVE, gen, bits1, ids1)
    cl.post(PHASE_COMMIT, 0, pid, wire.pack(CURVE, cpub), "bidder")
    board_commit = fetch_all(PHASE_COMMIT, 0, cpub)
    ok &= bool(seal.verify_commit(CURVE, board_commit, ids_all).all())

    # ---- auction steps (`SEAL/main.cpp:65-120`) ----
    in_race = 1
    junction = False
    prev_pub = None       # n-lane public snapshot of the deciding step
    prev_own = None       # own-lane secret snapshot (x, d)
    max_bid = 0
    for step in range(c):
        xr, v = seal.draw_round_one(CURVE, gen, 1, 1, dev)    # (2, 1, 1, L)
        pub1, sec1 = seal.round_one_from(CURVE, xr[:, 0], v[:, 0], ids1, step)
        cl.post(PHASE_ROUND1, step, pid, wire.pack(CURVE, pub1), "bidder")
        board_r1 = fetch_all(PHASE_ROUND1, step, pub1)
        ok &= bool(seal.verify_round_one(CURVE, board_r1, ids_all, step).all())

        Y_all = seal.avnet_keys(CURVE, board_r1.X)
        Y_own = Y_all[pid:pid + 1]
        d_own = bits1[:, step] & in_race
        own_r1 = seal.RoundOnePub(X=board_r1.X[pid:pid + 1],
                                  R=board_r1.R[pid:pid + 1],
                                  pok_x=None, pok_r=None)
        if not junction:
            pub2, _info = seal.round_two_stage1(
                CURVE, gen, sec1, own_r1, Y_own, cpub, csec, d_own, ids1, step)
        else:
            prev_1 = seal.StepInfo(
                X=prev_pub.X[pid:pid + 1], R=prev_pub.R[pid:pid + 1],
                Y=prev_pub.Y[pid:pid + 1], b=prev_pub.b[pid:pid + 1],
                x=prev_own[0], d=prev_own[1])
            pub2, _info = seal.round_two_stage2(
                CURVE, gen, sec1, own_r1, Y_own, cpub, csec, d_own, prev_1,
                ids1, step)
        cl.post(PHASE_ROUND2, step, pid, wire.pack(CURVE, pub2), "bidder")
        board_r2 = fetch_all(PHASE_ROUND2, step, pub2)
        if not junction:
            ok &= bool(seal.verify_round_two_stage1(
                CURVE, board_r2, board_r1, Y_all, board_commit, ids_all,
                step).all())
        else:
            ok &= bool(seal.verify_round_two_stage2(
                CURVE, board_r2, board_r1, Y_all, board_commit, prev_pub,
                ids_all, step).all())

        deciding = bool(seal.round_three(CURVE, board_r2.b))
        max_bid = (max_bid << 1) | int(deciding)
        if deciding:
            in_race &= int(d_own[0])
            junction = True
            prev_pub = seal.StepInfo(
                X=board_r1.X, R=board_r1.R, Y=Y_all, b=board_r2.b,
                x=torch.zeros((n, wire.LIMBS), dtype=torch.int64, device=dev),
                d=torch.zeros((n,), dtype=torch.int64, device=dev))
            prev_own = (sec1.x, d_own)

    if report_dir is not None:
        path = _report_path(report_dir, pid)
        with open(path + ".tmp", "w") as f:
            json.dump({"pid": pid, "device": str(board_r2.b.device),
                       "seconds": time.perf_counter() - t0,
                       "launches": dict(cuda_ec.launches),
                       "launch_lanes": [[k, lanes, v] for (k, lanes), v
                                        in cuda_ec.launch_lanes.items()]}, f)
        os.replace(path + ".tmp", path)
    payload = max_bid.to_bytes(RESULT_BYTES - 1, "big") + bytes([ok])
    cl.post(PHASE_RESULT, 0, pid, payload, "result")
    cl.close()


def warm_build(device="cuda"):
    """Build and load what the parties load: the native hub, and on a CUDA
    device the EC kernels (`cuda_ec.build`), so that n children never run
    make or nvcc at once.  The counterpart of the JAX driver's
    `warm_cache`, where building is compiling."""
    import torch

    from . import native

    native.load()
    if torch.device(device).type == "cuda":
        from ..ops import cuda_ec

        cuda_ec.build()


def _stop(procs):
    started = [p for p in procs if p.pid is not None]
    for p in started:
        if p.is_alive():
            p.terminate()
    for p in started:
        p.join(timeout=10)
        if p.is_alive():
            p.kill()
            p.join()


def serve_hub(sock_path: str, n: int) -> None:
    """The hub process: a board of n parties served on `sock_path` until the
    process is killed.  The driver never stops the server in place: on a
    kernel where shutting down a listening socket does not wake the thread
    blocked in its `accept` (some sandboxed kernels), `BoardServer.stop`
    waits forever; killing the hub's process ends it on every kernel."""
    from .native import NativeBoard

    board = NativeBoard(n)
    server = board.serve(sock_path)    # held, serving, until the kill
    while server is not None:
        time.sleep(3600)


def run_hub_auction(n: int, c: int, bids, seed: int = 0,
                    timeout_s: float = 600.0, warm: bool = True,
                    device="cuda", reports: list | None = None):
    """Spawn the hub process and n verified party processes on `device`;
    returns (results: list[(max_bid, ok)], meters: dict[str, int]).

    While it waits for the results it watches the children: as soon as a
    party (or the hub) exits with a non-zero code it stops the others and
    raises RuntimeError with that code; after `timeout_s` it raises
    TimeoutError.  It never returns partial results.  The meters are read
    from the hub through a client (BYTES and TOTAL requests, which meter
    nothing).  `reports`: a list that gets each party's report (pid,
    device, seconds, kernel launches by kernel and by (kernel, lanes)),
    which each party writes to a file beside the hub's socket, not through
    the hub, so the meters count protocol traffic only."""
    from .native import BoardClient

    if len(bids) != n:
        raise ValueError(f"{len(bids)} bids for {n} parties")
    if warm:
        warm_build(device)
    tmp = tempfile.mkdtemp(prefix="pa_hub_")
    sock = os.path.join(tmp, "board.sock")
    ctx = mp.get_context("spawn")
    hub = ctx.Process(target=serve_hub, args=(sock, n), daemon=True)
    procs = [ctx.Process(target=run_party,
                         args=(sock, i, n, c, int(bids[i]), seed, timeout_s,
                               str(device), tmp))
             for i in range(n)]
    cl = None

    def decode(raw):
        return int.from_bytes(raw[:-1], "big"), bool(raw[-1])

    try:
        hub.start()
        cl = BoardClient(sock, connect_timeout_s=60.0)
        for p in procs:
            p.start()
        results: dict[int, tuple[int, bool]] = {}
        deadline = time.monotonic() + timeout_s
        while len(results) < n:
            for i in range(n):
                if i not in results:
                    raw = cl.fetch(PHASE_RESULT, 0, i, "result")
                    if raw is not None:
                        results[i] = decode(raw)
            if hub.exitcode is not None:
                raise RuntimeError(f"the hub exited with code {hub.exitcode}")
            for i, p in enumerate(procs):
                if p.exitcode not in (None, 0):
                    raise RuntimeError(f"party {i} exited with code "
                                       f"{p.exitcode} before its result")
                if p.exitcode == 0 and i not in results:
                    raw = cl.fetch(PHASE_RESULT, 0, i, "result")
                    if raw is None:
                        raise RuntimeError(f"party {i} exited without a "
                                           "result")
                    results[i] = decode(raw)
            if time.monotonic() > deadline:
                raise TimeoutError(f"no result from parties "
                                   f"{sorted(set(range(n)) - set(results))} "
                                   f"within {timeout_s} s")
            time.sleep(POLL_S)
        for p in procs:
            p.join(timeout=60)
        bad = [(i, p.exitcode) for i, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"parties (index, exit code) {bad} did not "
                               "exit cleanly")
        meters = {k: cl.bytes(k) for k in ("bidder", "verifier", "result")}
        meters["total"] = cl.total_bytes()
        got = []
        if reports is not None:
            for i in range(n):
                with open(_report_path(tmp, i)) as f:
                    r = json.load(f)
                r["launch_lanes"] = {(k, lanes): v
                                     for k, lanes, v in r["launch_lanes"]}
                got.append(r)
    finally:
        _stop(procs)
        if cl is not None:
            cl.close()
        if hub.pid is not None:
            hub.kill()
            hub.join()
        shutil.rmtree(tmp, ignore_errors=True)
    if reports is not None:
        reports.extend(got)
    return [results[i] for i in range(n)], meters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m privacy_auction_tpu_torch.runtime.party",
        description="A verified SEAL auction of n party processes over the "
                    "native hub.")
    ap.add_argument("n", type=int, nargs="?", default=3)
    ap.add_argument("c", type=int, nargs="?", default=2)
    ap.add_argument("seed", type=int, nargs="?", default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    import random

    rng = random.Random(args.seed)
    bids = [rng.randrange(1 << args.c) for _ in range(args.n)]
    t0 = time.perf_counter()
    results, meters = run_hub_auction(args.n, args.c, bids, args.seed,
                                      device=args.device)
    want = max(bids)
    ok = all(r == (want, True) for r in results)
    print(f"[hub] n={args.n} c={args.c} device={args.device} bids={bids} -> "
          f"results={results}")
    print(f"[hub] meters: {meters}")
    print(f"[hub] {'OK' if ok else 'FAIL'}: verified multi-process maxBid="
          f"{want}, {time.perf_counter() - t0:.1f} s")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
