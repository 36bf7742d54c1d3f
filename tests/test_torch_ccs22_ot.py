"""The PyTorch port's CCS22 oblivious transfer against the JAX package: one
round trip (`ot_receive1_from`, `ot_send_from`, `ot_receive2`) at each
choice bit, fed the scalars and the AV-net ciphertexts the JAX functions
drew and gave (tests/data/torch_golden_ccs22.npz, written by
tools/torch_golden.py), reproduces the JAX messages limb for limb and the
announced bit."""

import torch

from privacy_auction_tpu_torch.curves import SECP256K1 as C
from privacy_auction_tpu_torch.protocols import ccs22
from torch_ccs22_cases import GOLD, assert_same, bits, draws, g

torch.set_num_threads(1)


def test_ccs22_ot_round_trip_matches_jax():
    pp = ccs22.pp_or_make(C, device="cpu")
    D = draws()
    d, B = bits()[:, 0], g("phase.B")
    beta, s, t = D.beta[:, 0], D.sec.s[:, 0], D.sec.t[:, 0]
    for eid in (0, 1):               # choice bits d[0] = 1 and d[1] = 0
        r1 = ccs22.ot_receive1_from(C, pp, beta, d[eid], g(f"ot{eid}.k"))
        assert_same(r1, f"ot{eid}.otr1")
        ots = ccs22.ot_send_from(C, pp, r1, B, s, t, g(f"ot{eid}.m1k"))
        assert_same(ots, f"ot{eid}.ots")
        ann = ccs22.ot_receive2(C, ots, beta, B, d, eid)
        assert bool(ann) == bool(GOLD[f"ot{eid}.announced"])
