"""Per-phase profiler ranges, wall times and role times, and the capture
of a fused step into a CUDA graph, shared by the auction drivers."""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from ..ops import cuda_ec


def phase_runner(prefix: str, phase_times: dict | None,
                 device: torch.device, times=None):
    """`phase(name, fn, *args, role=None)`: runs fn(*args) in a
    `torch.profiler` range named `<prefix>.<name>`.  With a `phase_times`
    dict it adds the call's wall time in seconds under `name`; with a
    `utils.trackers.TimeTracker` `times` and a role, under the role's
    category.  A timed call waits for the device before its clock stops."""
    def phase(name, fn, *args, role=None):
        with record_function(f"{prefix}.{name}"):
            by_role = times is not None and role is not None
            if phase_times is None and not by_role:
                return fn(*args)
            t0 = time.perf_counter()
            out = fn(*args)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            seconds = time.perf_counter() - t0
            if phase_times is not None:
                phase_times[name] = phase_times.get(name, 0.0) + seconds
            if by_role:
                times.add_time(role, seconds)
            return out
    return phase


def capture_graph(run, carried, pool=None):
    """Capture `run()`, one step on persistent buffers that reads nothing
    back to the host, into a CUDA graph.  First it warms `run` up once on a
    side stream (that builds the kernels, fills the cached constants and
    sets up cuBLAS, none of which a capture may do) and puts the `carried`
    tensors back; then it captures `run` on that stream into `pool` (a new
    pool when None) and instantiates the graph.  The warm-up's launches are
    not counted; the capture's are kept by (kernel, lanes), for
    `cuda_ec.add_launches` at each replay.  A capture that fails raises.
    Returns (graph, stats): the warm-up's, the capture's and the
    instantiation's seconds, the graph's kernel nodes, the device memory
    its pool took (bytes), the capture's launches, and replays and their
    seconds at 0 for the caller to fill."""
    dev = carried[0].device
    saved = [t.clone() for t in carried]
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    t0 = time.perf_counter()
    with cuda_ec.recorded(), torch.cuda.stream(stream):
        run()
    torch.cuda.current_stream(dev).wait_stream(stream)
    for t, v in zip(carried, saved):
        t.copy_(v)
    torch.cuda.synchronize(dev)
    warm = time.perf_counter() - t0
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved(dev)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    t0 = time.perf_counter()
    with cuda_ec.recorded() as launches, torch.cuda.graph(
            graph, pool=pool, stream=stream,
            capture_error_mode="thread_local"):
        run()
    captured = time.perf_counter() - t0
    kernels, instantiate = cuda_ec.instantiate(graph)
    torch.cuda.empty_cache()
    return graph, {
        "warmup_s": warm, "capture_s": captured, "instantiate_s": instantiate,
        "kernels": kernels,
        "memory_bytes": torch.cuda.memory_reserved(dev) - held,
        "replays": 0, "replay_s": 0.0, "launches": launches}
