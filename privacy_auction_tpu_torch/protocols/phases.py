"""Per-phase profiler ranges, wall times and role times, shared by the
auction drivers."""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function


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
