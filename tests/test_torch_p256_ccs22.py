"""A CCS22 auction on NIST P-256 on the port's CPU path, the auction of
tests/test_p256.py (bids [4, 9, 1], c = 4, evaluator 2): the maximum bid 9
is found.  P-256 runs the generic plain path (Barrett fields, RCB16 Alg
1/3, 64-window ladders without GLV)."""

import torch

from privacy_auction_tpu_torch.curves import get_curve
from privacy_auction_tpu_torch.protocols import ccs22

torch.set_num_threads(1)


def test_p256_ccs22_auction_end_to_end():
    res = ccs22.run_auction(get_curve("P-256"), [4, 9, 1], 4, 2,
                            generator=torch.Generator().manual_seed(8),
                            device="cpu")
    assert res.max_bid == 9
