"""Auctions on a bidder mesh of spawned ranks (the port's `parallel/`),
shared by tests/test_torch_parallel_*.py and chip_smoke.py's mesh phase.
Needs no JAX.

`Ranks(world, jobs, backend, device)` spawns `world` processes that start
a process group on localhost (the environment torchrun would set), build
the global bidder mesh and run each job's auction on it; each rank writes
its results to a file that the parent reads back.  Meanwhile the parent
can run the unsharded auctions (`unsharded`), so a test waits for the
slower of the two.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import socket
import tempfile
import time

import torch


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def leaves(tree) -> list:
    """The tensors of a board, in order, on the host."""
    if isinstance(tree, torch.Tensor):
        return [tree.cpu()]
    if tree is None:
        return []
    return [t for part in tree for t in leaves(part)]


def ec_job(job: dict, device, mesh=None) -> dict:
    """The EC ops that cross bidders, on `mesh`: the sum and the AV-net
    keys of job["n"] points from job["seed"] (k_i * G), and k_i * P_i
    lane by lane, each gathered to all n lanes."""
    import random

    from privacy_auction_tpu_torch.curves import SECP256K1 as C
    from privacy_auction_tpu_torch.ops import ec
    from privacy_auction_tpu_torch.ops import field as F
    from privacy_auction_tpu_torch.parallel import mesh as M
    from privacy_auction_tpu_torch.protocols import seal

    rng = random.Random(job["seed"])
    ks = [rng.randrange(1, C.host.n) for _ in range(job["n"])]
    scal = torch.as_tensor(F.ints_to_limbs(ks)).to(device)
    P = ec.mul_base(C, scal)
    Ps, ss = M.shard_bidders(mesh, (P, scal))
    return {"sum": ec.ec_sum(C, M.gather_bidders(mesh, Ps), dim=0).cpu(),
            "mul": M.gather_bidders(mesh, ec.scalar_mul(C, Ps, ss)).cpu(),
            "avnet": M.gather_bidders(mesh, seal.avnet_rows(C, Ps, mesh)).cpu()}


def run_job(job: dict, device, mesh=None) -> dict:
    """One auction of `job` (protocol "seal" or "ccs22", bids, c, seed;
    SEAL: verify, metered; CCS22: eval_id, metered) on `mesh`; its
    result with the board's tensors, the wall time, and the kernels'
    launches by kernel and lane count.  Protocol "ec": `ec_job`."""
    if job["protocol"] == "ec":
        return ec_job(job, device, mesh)
    from privacy_auction_tpu_torch.curves import SECP256K1 as C
    from privacy_auction_tpu_torch.ops import cuda_ec
    from privacy_auction_tpu_torch.protocols import ccs22, seal
    from privacy_auction_tpu_torch.utils.trackers import TimeTracker

    gen = torch.Generator().manual_seed(job["seed"])
    times = TimeTracker() if job.get("metered") else None
    seen = []

    def hook(phase, step, pub):
        seen.append((phase, step, pub.b.shape[0] if phase == "round2"
                     else pub.X.shape[0] if phase == "round1"
                     else pub.phi.shape[0]))
        return pub

    cuda_ec.reset_launches()
    t0 = time.perf_counter()
    if job["protocol"] == "seal":
        res = seal.run_auction(C, job["bids"], job["c"], verify=job["verify"],
                               generator=gen, device=device, times=times,
                               tamper=hook if times is not None else None,
                               mesh=mesh)
        verified = res.verified
    else:
        res = ccs22.run_auction(C, job["bids"], job["c"], job["eval_id"],
                                generator=gen, device=device, times=times,
                                mesh=mesh)
        verified = None
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"max_bid": res.max_bid, "verified": verified,
            "deciding": res.deciding_bits.tolist(),
            "board": leaves(res.board), "wall": wall, "hook": seen,
            "launches": dict(cuda_ec.launches),
            "launch_lanes": dict(cuda_ec.launch_lanes)}


def unsharded(job: dict, device="cpu") -> dict:
    """`run_job` without a mesh, on one thread as each rank runs (the
    caller's thread count is restored)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return run_job(job, device)
    finally:
        torch.set_num_threads(threads)


def _rank_main(rank, world, port, backend, device, jobs, out_dir):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    import torch.distributed as dist

    from privacy_auction_tpu_torch.parallel import distributed as D

    D.init(backend, device)
    try:
        mesh = D.global_mesh()
        out = {"rank": rank, "backend": dist.get_backend(),
               "info": D.process_info(),
               "runs": [run_job(job, device, mesh) for job in jobs]}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


class Ranks:
    """`world` spawned ranks running `jobs`; `results()` waits for them
    (at most `timeout` seconds) and returns each rank's output in rank
    order, raising if a rank failed."""

    def __init__(self, world: int, jobs, backend: str, device,
                 timeout: float = 600):
        self._dir = tempfile.TemporaryDirectory()
        self._timeout = timeout
        ctx = multiprocessing.get_context("spawn")
        port = free_port()
        self._procs = [ctx.Process(target=_rank_main,
                                   args=(r, world, port, backend, str(device),
                                         jobs, self._dir.name))
                       for r in range(world)]
        for p in self._procs:
            p.start()

    def results(self) -> list:
        try:
            deadline = time.monotonic() + self._timeout
            for p in self._procs:
                p.join(max(deadline - time.monotonic(), 0))
            codes = [p.exitcode for p in self._procs]
            if codes != [0] * len(codes):
                raise RuntimeError(f"mesh ranks exited with {codes} (None: "
                                   f"still running after {self._timeout} s)")
            out = []
            for r in range(len(self._procs)):
                with open(os.path.join(self._dir.name, f"rank{r}.pkl"), "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            for p in self._procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            self._dir.cleanup()


def same_board(a: list, b: list) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
