"""Where a SEAL auction's time goes on the GPU, for the PyTorch port.

    python tools/profile_torch_seal.py [--n 20] [--c 4] [--seed 1]

Runs one verified auction untraced (warm-up: kernel build, caches), then the
same auction under `torch.profiler` with CPU and CUDA activity, and prints,
for the whole auction and for each phase: wall time, GPU kernels run (copies
and fills counted apart), the summed GPU kernel time and its share of the
wall time (the device's busy share; one stream, so kernels do not overlap).
A phase's GPU work is what starts inside its `seal.<phase>` profiler range;
`run_auction` synchronizes the device at the end of each phase when it
times them, so no phase's work spills into the next.  The steps phase is
also given per step.  Last, the ten kernels with the most GPU time.  Needs a
CUDA device; prints "not measured" for device numbers when the profiler
records no device activity.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20)
    ap.add_argument("--c", type=int, default=4)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from privacy_auction_tpu_torch.curves import SECP256K1 as C
    from privacy_auction_tpu_torch.protocols import seal

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_seal: no CUDA device available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    bids = [(args.seed * 7919 + 104729 * i) % (1 << args.c) for i in range(args.n)]

    def auction(phase_times=None):
        return seal.run_auction(C, bids, args.c, verify=True,
                                generator=torch.Generator().manual_seed(args.seed),
                                device="cuda", phase_times=phase_times)

    auction()
    torch.cuda.synchronize()
    times = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = auction(times)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if not res.verified or res.max_bid != max(bids):
        raise SystemExit(f"auction failed: {res}")

    print(f"card: {smi}")
    print(f"SEAL {args.n}x{args.c} under the profiler: wall {wall:.3f} s")
    events = prof.events()
    # the phase ranges also show on the GPU timeline, as annotations
    gpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.name.startswith("seal.")]
    if not gpu:
        for k, v in times.items():
            print(f"  phase {k}: {v:.3f} s")
        print("device time: not measured (the profiler recorded no CUDA events)")
        return
    def is_kernel(e):
        return not e.name.startswith(("Memcpy", "Memset"))

    kernels = [e for e in gpu if is_kernel(e)]
    spans = {e.name[len("seal."):]: e.time_range for e in events
             if e.device_type == torch.autograd.DeviceType.CPU
             and e.name.startswith("seal.")}

    def line(label, ks, n_copies, seconds):
        busy = sum(e.device_time_total for e in ks) / 1e6
        print(f"  {label:18s} wall {seconds:8.3f} s  kernels {len(ks):8d}  "
              f"copies/fills {n_copies:6d}  kernel time {busy:7.3f} s  "
              f"busy {100 * busy / seconds:5.1f}%")

    print("phase breakdown (GPU work that starts inside the phase's range):")
    for name, seconds in times.items():
        tr = spans[name]
        inside = [e for e in gpu if tr.start <= e.time_range.start < tr.end]
        ks = [e for e in inside if is_kernel(e)]
        line(name, ks, len(inside) - len(ks), seconds)
        if name == "steps":
            print(f"  {'':18s} per step: {len(ks) / args.c:.0f} kernels, "
                  f"{seconds / args.c:.3f} s wall")
    line("whole auction", kernels, len(gpu) - len(kernels), wall)
    by_name = {}
    for e in kernels:
        cnt, tot = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (cnt + 1, tot + e.device_time_total)
    print("top GPU kernels by time (count, total ms, name):")
    for name, (cnt, tot) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"  {cnt:8d} {tot / 1e3:10.3f}  {name[:100]}")


if __name__ == "__main__":
    main()
