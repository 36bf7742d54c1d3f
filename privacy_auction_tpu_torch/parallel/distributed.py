"""Multi-process bring-up (torch.distributed) and the global bidder mesh.

Counterpart of `privacy_auction_tpu/parallel/distributed.py`.  A driver
goes from "torchrun started N processes" to a global bidder mesh in two
calls:

    from privacy_auction_tpu_torch.parallel import distributed as D
    D.init()                        # the environment torchrun sets
    mesh = D.global_mesh()          # 1-D mesh over every rank of the job
    seal.run_auction(..., mesh=mesh)

torchrun's MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK take
the place of the JAX package's JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES
and JAX_PROCESS_ID.  In one process with none of them set (tests, a single
run) `init()` changes nothing and `global_mesh()` is a mesh of one rank, so
the same driver code runs in both cases.  A rank is one member of the mesh
and computes on one device; the AV-net scan's and the veto sum's gathers
are the only collectives in a step (`mesh.py`).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .mesh import make_mesh

ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def init(backend: str | None = None, device="cuda") -> bool:
    """Start the process group from torchrun's environment.

    backend: "nccl" when the ranks compute on `device` cuda, "gloo" on the
    CPU, unless named.  On cuda each rank takes card LOCAL_RANK (modulo the
    host's cards, so that ranks beyond them share the cards in turn).

    Returns True if a process group is running after the call, False for a
    single process: with none of ENV set it changes nothing.  Safe to call
    more than once; only the first call starts the group.
    """
    if dist.is_initialized():
        return True
    if not any(k in os.environ for k in ENV):
        return False
    cuda = torch.device(device).type == "cuda"
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    if cuda:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method="env://")
    return True


def global_mesh():
    """1-D bidder mesh over every rank of the job.  Without a process group
    it is a mesh of one rank: a one-process gloo group over an in-memory
    store is started for it (no address, no network)."""
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    return make_mesh()


def process_info() -> dict:
    """Diagnostic summary for logs, with the JAX package's keys: this
    rank, the ranks of the job, the devices this process drives (one: a
    rank is one member of the mesh), the mesh's members, and whether the
    process sees a GPU."""
    started = dist.is_initialized()
    return {
        "process_index": dist.get_rank() if started else 0,
        "process_count": dist.get_world_size() if started else 1,
        "local_devices": 1,
        "global_devices": dist.get_world_size() if started else 1,
        "platform": "gpu" if torch.cuda.is_available() else "cpu",
    }
