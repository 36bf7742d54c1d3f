"""A verified SEAL auction on NIST P-256 on the port's CPU path: the
auction of tests/test_p256.py (bids [5, 3, 6, 2], c = 3) with n shrunk to
two bidders, [5, 6], for time, the check unchanged: every proof verifies
and the maximum bid 6 is found; the junction falls at step 0, so step 1
runs Stage2.  P-256 runs the generic plain path (Barrett fields, RCB16 Alg
1/3, 64-window ladders without GLV).

The auction runs under `torch.inference_mode()`, the same computation
without autograd's per-op bookkeeping (about 15% of this path's time on
the CPU).  One CPU thread: about 40 s here, about 47 s without inference
mode, 52-62 s at the original four bidders."""

import torch

from privacy_auction_tpu_torch.curves import get_curve
from privacy_auction_tpu_torch.protocols import seal

torch.set_num_threads(1)


def test_p256_seal_auction_end_to_end():
    with torch.inference_mode():
        res = seal.run_auction(get_curve("P-256"), [5, 6], 3, verify=True,
                               generator=torch.Generator().manual_seed(7),
                               device="cpu")
    assert res.verified and res.max_bid == 6
    assert res.deciding_bits.tolist() == [1, 1, 0]
