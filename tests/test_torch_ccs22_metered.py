"""The port's role-metered CCS22 driver (`run_auction(times=...)`) at bids
[2, 1, 3, 0], c = 2, evaluator 0, matches the JAX package's metered
driver (tests/data/torch_golden_metered.npz) in max bid, deciding bits and
bytes per category; both roles accrue time, and each of its four calls a
step has a phase time.  Its board against the fused driver's is
tests/test_torch_ccs22_metered_board.py."""

import numpy as np
import torch

from privacy_auction_tpu_torch.curves import SECP256K1 as C
from privacy_auction_tpu_torch.protocols import ccs22
from privacy_auction_tpu_torch.utils import trackers as T
from torch_metered_cases import GOLD, category_bytes

torch.set_num_threads(1)


def test_metered_ccs22_matches_jax():
    bids = [int(b) for b in GOLD["ccs22.bids"]]
    c, eid = int(GOLD["ccs22.c"]), int(GOLD["ccs22.eval_id"])
    data, times, phase_times = T.DataTracker(), T.TimeTracker(), {}
    res = ccs22.run_auction(C, bids, c, eid, device="cpu",
                            generator=torch.Generator().manual_seed(13),
                            times=times, phase_times=phase_times,
                            trackers=T.Ccs22CommTracker(data))
    assert res.max_bid == int(GOLD["ccs22.max_bid"]) == max(bids)
    np.testing.assert_array_equal(res.deciding_bits,
                                  GOLD["ccs22.deciding_bits"])
    assert category_bytes(data, "ccs22") == GOLD["ccs22.bytes"].tolist()
    assert times.get_category_time_seconds(T.CATEGORY_BIDDER) > 0
    assert times.get_category_time_seconds(T.CATEGORY_EVALUATOR) > 0
    assert set(phase_times) == {"setup", "bes_encode", "ot_receive1",
                                "ot_send", "ot_receive2"}
