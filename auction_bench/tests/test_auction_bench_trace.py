"""The profiler reduction on a timeline made by hand."""

import pytest
import torch

from auction_bench import trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Ev:
    def __init__(self, name, start, dur, device=CUDA, annotation=False):
        self._n, self._s, self._d = name, start, dur
        self._dev, self._a = device, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def is_user_annotation(self):
        return self._a


def timeline():
    ms = 1_000_000
    return [
        Ev("auction_bench.auction", 0, 100 * ms, CPU, True),
        Ev("seal.commit", 0, 40 * ms, CPU, True),
        Ev("seal.steps", 40 * ms, 60 * ms, CPU, True),
        Ev("seal.capture", 40 * ms, 30 * ms, CPU, True),
        Ev("seal.steps", 40 * ms, 60 * ms, CUDA, True),   # mirrored range
        Ev("aten::add", 1 * ms, 1 * ms, CPU),
        Ev("void mul_comb_kernel<8>(Args)", 10 * ms, 10 * ms),
        Ev("elementwise", 15 * ms, 10 * ms),               # overlaps: 10-25
        Ev("void sha256_kernel(Args)", 80 * ms, 5 * ms),
        Ev("void quad_mul_kernel<4>(Args)", 90 * ms, 10 * ms),
        Ev("void pt_add_kernel<8>(Args)", 150 * ms, 1 * ms),  # outside
    ]


def test_busy_idle_and_kernels():
    s = trace.summarize(timeline())
    assert s["window_s"] == pytest.approx(0.1)
    assert s["busy_s"] == pytest.approx(0.030)      # 10-25, 80-85, 90-100
    assert s["ec_kernel_count"] == 2
    assert s["ec_kernel_s"] == pytest.approx(0.020)
    assert s["sha256_kernel_count"] == 1
    assert s["sha256_kernel_s"] == pytest.approx(0.005)
    assert s["device_ops"][0] == ["void mul_comb_kernel<8>(Args)",
                                  pytest.approx(0.010)]


def test_idle_gaps_by_innermost_host_range():
    gaps = dict(trace.summarize(timeline())["idle_gaps"])
    # 0-10 and 25-40 in commit; 40-70 in capture; 70-80, 85-90 in steps
    assert gaps["seal.commit"] == pytest.approx(0.025)
    assert gaps["seal.capture"] == pytest.approx(0.030)
    assert gaps["seal.steps"] == pytest.approx(0.015)
    assert sum(gaps.values()) == pytest.approx(0.070)


def test_no_device_activity_gives_nothing():
    assert trace.summarize([e for e in timeline()
                            if e.device_type() == CPU]) is None
