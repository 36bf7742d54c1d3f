"""The traced run's reading of `torch.profiler`: the device's timeline
over the profiled auctions, reduced to sums the per-layer metrics read.

Device operations are the profiler's CUDA activities (kernels, copies,
fills; not the ranges it mirrors onto the device's timeline).  The traced
window runs from the start of the first profiled auction's
`auction_bench.auction` range to the end of the last one's.  Busy time is
the union of the device operations inside it; an idle gap is a stretch of
the window with none, split among the innermost host ranges around it
(the program's `seal.*` / `ccs22.*` ranges, else the harness's own).
"""

from __future__ import annotations

import bisect
import re

import numpy as np
import torch

AUCTION_RANGE = "auction_bench.auction"
EC_KERNEL = re.compile(r"\b(mul_comb|scalar_mul|dual_mul|quad_mul|"
                       r"base_mul_add_glv|base_mul_add|pt_add)_kernel\b")
SHA256_KERNEL = re.compile(r"\bsha256_kernel\b")
TOP = 10
# the ranges of the harness and the program; the profiler also mirrors
# them onto the device's timeline, where they are no device operation
RANGE_PREFIXES = ("auction_bench.", "seal.", "ccs22.")


def summarize(events) -> dict | None:
    """`prof.profiler.kineto_results.events()` -> the traced window's sums:
    window_s, busy_s, device seconds and counts by operation name, the EC
    and SHA-256 kernels' seconds and counts, the idle seconds by host
    range; None when the profiler recorded no device operation."""
    cuda = torch.autograd.DeviceType.CUDA
    names, starts, ends, host = [], [], [], []
    for e in events:
        name = e.name()
        ranged = e.is_user_annotation() or name.startswith(RANGE_PREFIXES)
        if e.device_type() == cuda:
            if not ranged:
                names.append(name)
                starts.append(e.start_ns())
                ends.append(e.start_ns() + e.duration_ns())
        elif ranged:
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    auctions = [(s, t) for s, t, name in host if name == AUCTION_RANGE]
    if not names or not auctions:
        return None
    w0 = min(s for s, _ in auctions)
    w1 = max(t for _, t in auctions)
    starts = np.asarray(starts, dtype=np.int64)
    ends = np.asarray(ends, dtype=np.int64)
    inside = (ends > w0) & (starts < w1)
    idx = np.nonzero(inside)[0]
    s = np.clip(starts[idx], w0, w1)
    t = np.clip(ends[idx], w0, w1)
    order = np.argsort(s, kind="stable")
    s, t = s[order], t[order]
    reach = np.maximum.accumulate(t)
    # gaps: before the first operation, between operations, after the last
    gap_lo = np.concatenate([[w0], reach])
    gap_hi = np.concatenate([s, [w1]])
    gap = gap_hi - gap_lo
    idle = gap > 0
    busy_ns = (w1 - w0) - int(gap[idle].sum())

    by_name: dict[str, list] = {}
    for k in idx:
        entry = by_name.setdefault(names[k], [0, 0])
        entry[0] += 1
        entry[1] += int(ends[k] - starts[k])
    ec = [(n, v) for n, v in by_name.items() if EC_KERNEL.search(n)]
    sha = [(n, v) for n, v in by_name.items() if SHA256_KERNEL.search(n)]
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP]
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "device_ops": [[n, v[1] / 1e9] for n, v in top_ops],
        "idle_gaps": _idle_by_range(gap_lo[idle], gap_hi[idle], host, w0, w1),
        "ec_kernel_s": sum(v[1] for _, v in ec) / 1e9,
        "ec_kernel_count": sum(v[0] for _, v in ec),
        "sha256_kernel_s": sum(v[1] for _, v in sha) / 1e9,
        "sha256_kernel_count": sum(v[0] for _, v in sha),
    }


def _idle_by_range(lo, hi, host, w0, w1) -> list:
    """Idle seconds by the innermost host range around each stretch of
    each gap, the TOP largest, as [name, seconds]."""
    ranges = [(s, t, n) for s, t, n in host if t > w0 and s < w1]
    cuts = sorted({w0, w1} | {max(w0, min(w1, v)) for s, t, _ in ranges
                              for v in (s, t)})
    labels = []
    for a, b in zip(cuts, cuts[1:]):
        mid = (a + b) / 2
        around = [(t - s, n) for s, t, n in ranges if s <= mid < t]
        labels.append(min(around)[1] if around else "between auctions")
    total: dict[str, int] = {}
    for a, b in zip(lo.tolist(), hi.tolist()):
        k = max(bisect.bisect_right(cuts, a) - 1, 0)
        while a < b and k < len(labels):
            end = min(b, cuts[k + 1])
            total[labels[k]] = total.get(labels[k], 0) + (end - a)
            a, k = end, k + 1
    top = sorted(total.items(), key=lambda kv: -kv[1])[:TOP]
    return [[n, v / 1e9] for n, v in top]
