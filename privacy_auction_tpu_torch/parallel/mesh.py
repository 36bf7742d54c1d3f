"""The bidder-sharded mesh: the bulletin board's bidder axis split over the
ranks of a process group.

Counterpart of `privacy_auction_tpu/parallel/mesh.py`, in PyTorch's idiom.
The JAX package shards its arrays over a 1-D `jax.sharding.Mesh` and lets
XLA insert the collectives.  Here the mesh is a 1-D
`torch.distributed.device_mesh.DeviceMesh` whose one dim is BIDDER_AXIS;
each rank is one process that holds a contiguous block of the bidder rows
and computes on them, and the drivers call the collectives themselves,
only where the protocol crosses bidders:

  * `shard_bidders(mesh, tree, dim)` keeps this rank's rows of each leaf's
    bidder axis (`bidder_rows`).  It stands for the JAX package's
    `bidder_spec`, `bidder_sharding` and `shard_bidders` (a `device_put`
    with the bidder axis sharded);
  * `gather_bidders(mesh, tree, dim)`: an `all_gather` in rank order, the
    collective XLA inserts by itself in the JAX package (the AV-net prefix
    scan, the veto sum);
  * `all_true(mesh, flag)`: the JAX package's `all_ok` psum;
  * `replicate(mesh, value)`: a broadcast from rank 0 (`new_generator`:
    rank 0's seed on every rank).

`mesh=None` is one process holding every row: each function returns its
input.  A gloo group moves host tensors, so a CUDA tensor goes to the host
for a gloo collective and comes back; an NCCL group moves CUDA tensors.
The compute stays on the device the driver was given.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

BIDDER_AXIS = "bidders"


def make_mesh(n_devices: int | None = None,
              device_type: str | None = None) -> DeviceMesh:
    """1-D mesh over the first `n_devices` ranks of the process group (all
    of them by default).  Every rank of the group must call it.

    device_type: what the group's collectives move, "cuda" for an NCCL
    group and "cpu" for gloo by default.  The ranks compute on the device
    their drivers are given either way.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "parallel.distributed.init() under torchrun, or "
                           "use parallel.distributed.global_mesh()")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if not 1 <= n_devices <= world:
        raise ValueError(f"requested a {n_devices}-rank mesh but the process "
                         f"group has world size {world} (backend "
                         f"{dist.get_backend()}); start more ranks, e.g. "
                         f"torchrun --nproc-per-node={n_devices}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n_devices),
                      mesh_dim_names=(BIDDER_AXIS,))


def pad_bidders(n: int, n_devices: int) -> int:
    """Smallest padded bidder count divisible by the mesh size."""
    return ((n + n_devices - 1) // n_devices) * n_devices


def mesh_size(mesh: DeviceMesh | None) -> int:
    return 1 if mesh is None else mesh.size()


def bidder_rows(mesh: DeviceMesh | None, n: int) -> slice:
    """This rank's contiguous block of n bidder rows (all of them without a
    mesh).  n must be a multiple of the mesh size (`pad_bidders`)."""
    if mesh is None:
        return slice(0, n)
    d = mesh.size()
    if n % d:
        raise ValueError(f"{n} bidders do not split over {d} ranks; pad "
                         "them first (pad_bidders)")
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    k = n // d
    return slice(coord[0] * k, (coord[0] + 1) * k)


def _leaves(tree):
    """(tensor leaves in order, rebuild(leaves) -> tree) of a nest of
    tuples, NamedTuples and lists with tensors or None."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda ls: ls[0]
    if tree is None:
        return [], lambda ls: None
    parts = [_leaves(t) for t in tree]
    sizes = [len(p[0]) for p in parts]

    def rebuild(ls):
        out, i = [], 0
        for (_, fn), k in zip(parts, sizes):
            out.append(fn(ls[i:i + k]))
            i += k
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return [t for p in parts for t in p[0]], rebuild


def shard_bidders(mesh: DeviceMesh | None, tree, dim: int = 0):
    """This rank's rows (`bidder_rows`) along `dim` of every leaf."""
    if mesh is None:
        return tree
    leaves, rebuild = _leaves(tree)
    out = []
    for t in leaves:
        rows = bidder_rows(mesh, t.shape[dim])
        out.append(t.narrow(dim, rows.start, rows.stop - rows.start))
    return rebuild(out)


def _host(mesh: DeviceMesh) -> bool:
    return dist.get_backend(mesh.get_group(BIDDER_AXIS)) == "gloo"


def gather_bidders(mesh: DeviceMesh | None, tree, dim: int = 0):
    """Every rank's rows along `dim` of every leaf, in rank order: the whole
    bidder axis, on every rank.  The leaves travel as one int64 buffer (one
    `all_gather` a call) and come back in their dtypes and on their
    devices."""
    if mesh is None:
        return tree
    leaves, rebuild = _leaves(tree)
    if not leaves:
        return tree
    rows = [t.movedim(dim, 0) for t in leaves]
    k = rows[0].shape[0]
    if any(r.shape[0] != k for r in rows):
        raise ValueError("gather_bidders: the leaves hold different numbers "
                         "of bidder rows")
    widths = [r[0].numel() if k else 0 for r in rows]
    buf = torch.cat([r.reshape(k, -1).to(torch.int64) for r in rows], dim=1)
    if _host(mesh):
        buf = buf.cpu()
    parts = [torch.empty_like(buf) for _ in range(mesh.size())]
    dist.all_gather(parts, buf.contiguous(), group=mesh.get_group(BIDDER_AXIS))
    full = torch.cat(parts)
    out, at = [], 0
    for t, r, w in zip(leaves, rows, widths):
        piece = full[:, at:at + w].reshape((full.shape[0],) + r.shape[1:])
        out.append(piece.to(device=t.device, dtype=t.dtype).movedim(0, dim))
        at += w
    return rebuild(out)


def all_true(mesh: DeviceMesh | None, flag) -> bool:
    """True iff `flag` (a bool tensor) holds everywhere on every rank."""
    ok = flag.all()
    if mesh is None:
        return bool(ok.item())
    v = ok.to(torch.int64).reshape(1)
    if _host(mesh):
        v = v.cpu()
    dist.all_reduce(v, op=dist.ReduceOp.MIN, group=mesh.get_group(BIDDER_AXIS))
    return bool(v.item())


def new_generator(mesh: DeviceMesh | None) -> torch.Generator:
    """A fresh OS-seeded CPU generator; on a mesh every rank takes rank 0's
    seed, so that all ranks draw the same nonces."""
    generator = torch.Generator()
    seed = torch.tensor(generator.seed() & (2 ** 63 - 1))
    generator.manual_seed(int(replicate(mesh, seed)))
    return generator


def replicate(mesh: DeviceMesh | None, value: torch.Tensor) -> torch.Tensor:
    """Rank 0's `value` on every rank (same shape and dtype on each)."""
    if mesh is None:
        return value
    v = value.clone()
    if _host(mesh):
        v = v.cpu()
    group = mesh.get_group(BIDDER_AXIS)
    dist.broadcast(v, src=dist.get_global_rank(group, 0), group=group)
    return v.to(value.device)
