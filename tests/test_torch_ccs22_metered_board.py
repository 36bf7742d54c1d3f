"""Fed the same draws, the port's two CCS22 drivers publish the same board
(bids [2, 1, 3], c = 2, evaluator 2): the announced bits, every setup
message and T2, z limb for limb, and G, H, C0, C1, which the fused driver
assembles from its hoisted passes in another projective form, as the
same SEC1 bytes, which is what a party publishes."""

import torch

from privacy_auction_tpu_torch.curves import SECP256K1 as C
from privacy_auction_tpu_torch.ops import ec
from privacy_auction_tpu_torch.protocols import ccs22
from privacy_auction_tpu_torch.utils import trackers as T

torch.set_num_threads(1)

BIDS, C_BITS, EVAL = [2, 1, 3], 2, 2


def test_metered_and_fused_publish_the_same_board():
    draws = ccs22.draw(C, torch.Generator().manual_seed(13), len(BIDS),
                       C_BITS, "cpu")
    fused, metered = (
        ccs22.run_auction(C, BIDS, C_BITS, EVAL, device="cpu", draws=draws,
                          times=times).board
        for times in (None, T.TimeTracker()))
    assert torch.equal(fused.announced, metered.announced)
    assert fused.announced.tolist() == [True, True]
    for part in ("setup", "otr1", "ots"):
        for name, a, b in zip(getattr(fused, part)._fields,
                              getattr(fused, part), getattr(metered, part)):
            if name in ("G", "H", "C0", "C1"):
                a = ec.serialize_uncompressed(C, a)
                b = ec.serialize_uncompressed(C, b)
            assert torch.equal(a, b), f"{part}.{name}"
