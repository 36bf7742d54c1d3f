"""Per-phase profiler ranges and wall times, shared by the auction drivers."""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function


def phase_runner(prefix: str, times: dict | None, device: torch.device):
    """`phase(name, fn, *args)`: runs fn(*args) in a `torch.profiler` range
    named `<prefix>.<name>`; with a `times` dict, adds its wall time in
    seconds, taken after a device synchronize, under `name`."""
    def phase(name, fn, *args):
        with record_function(f"{prefix}.{name}"):
            if times is None:
                return fn(*args)
            t0 = time.perf_counter()
            out = fn(*args)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            times[name] = times.get(name, 0.0) + time.perf_counter() - t0
            return out
    return phase
