"""A verified SEAL auction of three party processes of the port over the
native hub (`privacy_auction_tpu_torch/runtime/party.py`) on the CPU, with
tests/test_native_auction.py's bids and seed: every party verifies every
proof and finds the plaintext maximum, the port's in-process driver agrees,
and the hub's byte meters equal that file's formula exactly (65 B a point,
32 B a scalar: the JAX package's meters).  A party that dies is
tests/test_torch_hub_dead_party.py."""

import numpy as np
import pytest
import torch

from privacy_auction_tpu_torch.curves import SECP256K1 as CURVE
from privacy_auction_tpu_torch.protocols import seal
from privacy_auction_tpu_torch.runtime import native
from privacy_auction_tpu_torch.runtime.party import RESULT_BYTES, run_hub_auction
from privacy_auction_tpu_torch.utils import trackers as T

torch.set_num_threads(1)

N, C = 3, 2
SEED = 11


def test_hub_auction_agrees_and_meters():
    if not native.available():
        pytest.skip("native runtime not built and no toolchain")
    rng = np.random.default_rng(SEED)
    bids = [int(b) for b in rng.integers(0, 1 << C, N)]
    reports = []
    results, meters = run_hub_auction(N, C, bids, seed=SEED, device="cpu",
                                      reports=reports)
    want = max(bids)
    assert results == [(want, True)] * N
    assert [r["pid"] for r in reports] == list(range(N))
    assert {r["device"] for r in reports} == {"cpu"}
    assert all(not any(r["launches"].values()) for r in reports)

    res = seal.run_auction(CURVE, bids, C, verify=True,
                           generator=torch.Generator().manual_seed(SEED),
                           device="cpu")
    assert res.verified and res.max_bid == want

    # wire sizes per party: commit 9 points + 5 scalars a bit; round one
    # 4 + 2; round two 9 + 5 (Stage1) or 17 + 10 (Stage2)
    deciding = [(want >> (C - 1 - s)) & 1 for s in range(C)]
    stage2 = False
    per_party = C * T.SEAL_COMMIT_PER_BIT
    for s in range(C):
        per_party += T.SEAL_ROUND1
        per_party += T.SEAL_ROUND2_S2 if stage2 else T.SEAL_ROUND2_S1
        stage2 = stage2 or bool(deciding[s])
    assert meters["bidder"] == N * per_party
    assert meters["verifier"] == N * N * per_party
    # each party posts its result, the driver fetches each once
    assert meters["result"] == 2 * N * RESULT_BYTES
    assert meters["total"] == (meters["bidder"] + meters["verifier"]
                               + meters["result"])
