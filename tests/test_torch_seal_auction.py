"""A whole verified SEAL auction on the PyTorch port's CPU path gives the
JAX package's recorded outcome (tests/data/torch_golden_seal.npz, written
by tools/torch_golden.py) and the plaintext maximum.  The bids' MSB is set,
so the auction runs Stage1 and then Stage2."""

import numpy as np
import torch

from privacy_auction_tpu_torch.curves import SECP256K1 as C
from privacy_auction_tpu_torch.protocols import seal
from torch_golden_cases import GOLD

torch.set_num_threads(1)


def test_auction_matches_jax_outcome():
    bids = [int(b) for b in GOLD["auction_bids"]]
    c = int(GOLD["auction_c"])
    times = {}
    res = seal.run_auction(C, bids, c, verify=True,
                           generator=torch.Generator().manual_seed(5),
                           device="cpu", phase_times=times)
    assert res.max_bid == int(GOLD["auction_max_bid"]) == max(bids)
    assert res.verified == bool(GOLD["auction_verified"]) is True
    np.testing.assert_array_equal(res.deciding_bits,
                                  GOLD["auction_deciding_bits"])
    assert set(times) == {"commit", "verify_commit", "round_one",
                          "verify_round_one", "avnet", "b01", "steps"}
