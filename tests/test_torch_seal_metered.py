"""The port's two SEAL drivers agree: from the same seed, the role-metered
loop (`run_auction(times=...)`) and the fused driver give the same max
bid and deciding bits, publish the same board limb for limb, charge the
same bytes, and leave the generator in the same state, because the
metered loop draws its nonces in the fused driver's order.  Bids [2, 3],
c = 2: Stage1 at step 0, Stage2 at step 1.  Verification is off (it
draws nothing and publishes nothing; the checks are held to the JAX
package in tests/test_torch_seal_tamper_*.py)."""

import torch

from privacy_auction_tpu_torch.curves import SECP256K1 as C
from privacy_auction_tpu_torch.protocols import seal
from privacy_auction_tpu_torch.utils import trackers as T

torch.set_num_threads(1)

BIDS, C_BITS = [2, 3], 2


def _assert_same(a, b, path="board"):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
        return
    assert type(a) is type(b) and len(a) == len(b), path
    for i, (x, y) in enumerate(zip(a, b)):
        name = a._fields[i] if hasattr(a, "_fields") else str(i)
        if x is None or y is None:
            assert x is None and y is None, f"{path}.{name}"
        else:
            _assert_same(x, y, f"{path}.{name}")


def test_metered_and_fused_publish_the_same_board():
    runs = []
    for times in (None, T.TimeTracker()):
        gen = torch.Generator().manual_seed(11)
        data = T.DataTracker()
        res = seal.run_auction(C, BIDS, C_BITS, verify=False, generator=gen,
                               device="cpu", times=times,
                               trackers=T.SealCommTracker(data))
        runs.append((res, gen.get_state(), data.get_total_data_mb()))
    (fused, state_f, mb_f), (metered, state_m, mb_m) = runs
    assert fused.max_bid == metered.max_bid == max(BIDS)
    assert fused.deciding_bits.tolist() == metered.deciding_bits.tolist() == [1, 1]
    assert [p.proof2 is None for p in metered.board.round2] == [True, False]
    _assert_same(fused.board, metered.board)
    assert torch.equal(state_f, state_m)
    assert mb_f == mb_m > 0
