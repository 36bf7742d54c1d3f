"""Instrumentation: time and communication accounting.

Equivalents of the reference's cross-cutting singletons
(`include/timeTracker.h:10-77`, `include/dataTracker.h:8-53`): per-category
wall-time bracketing and serialized-byte counting.  A copy of
`privacy_auction_tpu/utils/trackers.py` without JAX, so the PyTorch port
imports nothing of the JAX package; `TimeTracker.track` waits for the CUDA
device that holds its result instead of `jax.block_until_ready`.

The communication model is computed analytically from the protocol's
message formulas (message counts are static given n, c), as in the JAX
package: 65 B per uncompressed EC point, and scalars counted at their full
32-byte canonical width (the reference's BN_num_bytes is value-dependent,
< 32 for ~0.4% of uniform scalars).
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict

import torch

POINT_BYTES = 65   # SEC1 uncompressed (`SEAL/bulletinBoard.cpp:275-281`)
SCALAR_BYTES = 32  # canonical BE width (`SEAL/bulletinBoard.cpp:283-288`)

CATEGORY_BIDDER = "bidder"
CATEGORY_VERIFIER = "verifier"
CATEGORY_EVALUATOR = "evaluator"
# CCS22 costs shared by every party, e.g. CRS download
# (`CCS22/params.h:11`, `CCS22/bulletinBoard.cpp:63-75`)
CATEGORY_BIDDER_AND_EVALUATOR = "bidder_and_evaluator"

# CRS transfer per party (`CCS22/bulletinBoard.cpp:63-75,184-209`):
# curve params p (32 B) + a (0 B for a=0) + b (1 B) + 3 ints (12 B),
# points g, g1, h (65 B each), group order (32 B).
CCS22_CRS_BYTES = (32 + 0 + 1 + 12) + 3 * 65 + 32


def block_until_ready(result):
    """Wait for the device work that produces `result` (a tensor or a
    nested tuple/list of them): synchronizes the CUDA device of its first
    CUDA tensor; CPU tensors are ready when returned."""
    stack = [result]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                torch.cuda.synchronize(x.device)
                return
        elif isinstance(x, (tuple, list)):
            stack.extend(reversed(x))


class TimeTracker:
    """Per-category accumulated wall time (`include/timeTracker.h:10-77`).

    Thread-safe like the reference's mutex-guarded singleton; `track`
    blocks on device completion so device time is attributed correctly.
    """

    _instance = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self._lock = threading.Lock()
        self._acc = defaultdict(float)
        self._open = {}

    @classmethod
    def get_instance(cls) -> "TimeTracker":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def start(self, category: str):
        with self._lock:
            self._open[category] = time.perf_counter()

    def stop(self, category: str):
        with self._lock:
            t0 = self._open.pop(category, None)
            if t0 is not None:
                self._acc[category] += time.perf_counter() - t0

    def track(self, category: str, result=None):
        """Context manager: brackets a region; blocks on `result` at exit."""
        tracker = self

        class _Ctx:
            def __enter__(self):
                tracker.start(category)

            def __exit__(self, *exc):
                if result is not None:
                    block_until_ready(result)
                tracker.stop(category)

        return _Ctx()

    def add_time(self, category: str, seconds: float):
        """Direct adjustment (may be negative): used to re-attribute a
        share of a batched call to another role category."""
        with self._lock:
            self._acc[category] += seconds

    def get_category_time_seconds(self, category: str) -> float:
        with self._lock:
            return self._acc[category]

    def reset(self):
        with self._lock:
            self._acc.clear()
            self._open.clear()


class DataTracker:
    """Per-category byte counter (`include/dataTracker.h:8-53`)."""

    _instance = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self._lock = threading.Lock()
        self._acc = defaultdict(int)

    @classmethod
    def get_instance(cls) -> "DataTracker":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def add_data(self, category: str, nbytes: int):
        with self._lock:
            self._acc[category] += int(nbytes)

    def get_category_data_mb(self, category: str) -> float:
        with self._lock:
            return self._acc[category] / 1e6

    def get_total_data_mb(self) -> float:
        with self._lock:
            return sum(self._acc.values()) / 1e6

    def reset(self):
        with self._lock:
            self._acc.clear()


def _msg(points: int, scalars: int) -> int:
    return points * POINT_BYTES + scalars * SCALAR_BYTES


# per-message sizes (points, scalars), from the SEAL wire types
# (`SEAL/types.h:13-144`): PoKDLog = 1 pt + 1 sc; PoWFCom = 4 pt + 3 sc;
# Stage1 = 8 pt + 5 sc; Stage2 = 16 pt + 10 sc.
SEAL_COMMIT_PER_BIT = _msg(3 + 2 * 1 + 4, 2 * 1 + 3)      # phi,A,B + 2 PoK + PoWFCom
SEAL_ROUND1 = _msg(2 + 2 * 1, 2 * 1)                       # X,R + 2 PoK
SEAL_ROUND2_S1 = _msg(1 + 8, 5)                            # b + Stage1
SEAL_ROUND2_S2 = _msg(1 + 16, 10)                          # b + Stage2


class SealCommTracker:
    """Analytic SEAL communication model mirroring the reference's metering
    (`SEAL/bulletinBoard.cpp:26-270`): uploads counted for the bidder
    category; per-verifier downloads (each of the n parties re-fetches all
    n messages) for the verifier category."""

    def __init__(self, data: DataTracker | None = None):
        self.data = data or DataTracker.get_instance()

    def account_commit(self, n: int, c: int):
        per_bidder = c * SEAL_COMMIT_PER_BIT
        self.data.add_data(CATEGORY_BIDDER, n * per_bidder)
        self.data.add_data(CATEGORY_VERIFIER, n * n * per_bidder)

    def account_step(self, n: int, stage2: bool):
        r2 = SEAL_ROUND2_S2 if stage2 else SEAL_ROUND2_S1
        self.data.add_data(CATEGORY_BIDDER, n * (SEAL_ROUND1 + r2))
        self.data.add_data(
            CATEGORY_VERIFIER, n * n * (SEAL_ROUND1 + r2)
        )
        # round-2 inputs (getRoundOneXs) + round-3 inputs (getRoundTwoBs):
        # every bidder downloads n points each time
        self.data.add_data(CATEGORY_BIDDER, 2 * n * n * POINT_BYTES)


class Ccs22CommTracker:
    """Analytic CCS22 communication model
    (`CCS22/bulletinBoard.cpp:11-224`)."""

    def __init__(self, data: DataTracker | None = None):
        self.data = data or DataTracker.get_instance()

    def account_setup(self, n: int, c: int):
        # CRS distribution: every party downloads the group description
        # (`CCS22/bulletinBoard.cpp:63-75`, metered whole-group)
        self.data.add_data(CATEGORY_BIDDER_AND_EVALUATOR, n * CCS22_CRS_BYTES)
        per_party = _msg(1 + c, 0)  # Com + c public keys
        self.data.add_data(CATEGORY_BIDDER, n * per_party)

    def account_step(self, n: int):
        # per-step key fan-out: each party downloads the n step keys
        self.data.add_data(CATEGORY_BIDDER, n * n * POINT_BYTES)
        # OT round 1 (evaluator -> each bidder: T2, G, H)
        self.data.add_data(CATEGORY_EVALUATOR, (n - 1) * _msg(3, 0))
        # OT round 2 (each bidder -> evaluator: z, C0, C1)
        self.data.add_data(CATEGORY_BIDDER, (n - 1) * _msg(3, 0))
        # announced bit
        self.data.add_data(CATEGORY_EVALUATOR, n)
