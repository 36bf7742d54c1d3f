"""The PyTorch port's CCS22 phases against the JAX package: the CRS, and
`setup_from` and `bes_encode`, each fed the scalars the JAX functions drew
(tests/data/torch_golden_ccs22.npz, written by tools/torch_golden.py),
reproduce the JAX messages limb for limb.  The OT round trip is in
tests/test_torch_ccs22_ot.py.  The hoisted ladder passes reach the JAX
messages through the whole auctions of tests/test_torch_ccs22_auction*.py,
and are held to the recorded streams on the card in
tests/test_torch_cuda.py."""

import hashlib

import numpy as np
import torch

from privacy_auction_tpu_torch.curves import SECP256K1 as C
from privacy_auction_tpu_torch.ops import field as F
from privacy_auction_tpu_torch.protocols import ccs22
from torch_ccs22_cases import EVALS, GOLD, assert_same, bits, draws, g

torch.set_num_threads(1)


def _check_crs(pp):
    assert torch.equal(pp.g1, g("crs.g1")) and torch.equal(pp.h, g("crs.h"))
    for name in ("g1_table", "h_table"):
        raw = np.ascontiguousarray(getattr(pp, name).numpy().astype("<u2"))
        assert (hashlib.sha256(raw.tobytes()).digest()
                == GOLD[f"crs.{name}_sha256"].tobytes()), name


def test_ccs22_phases_match_jax():
    pp = ccs22.make_pub_params(C, device="cpu")
    _check_crs(pp)
    D = draws()
    bids = torch.as_tensor(F.ints_to_limbs([int(b) for b in GOLD["bids"]]))
    eid = EVALS[-1]
    assert_same(ccs22.setup_from(C, pp, bids, D.sec, eid, D.beta),
                f"e{eid}.setup_pub")
    X = g(f"e{eid}.setup_pub.X")
    B = ccs22.bes_encode(C, X[:, 0], D.sec.x[:, 0], D.sec.r[:, 0],
                         bits()[:, 0])
    np.testing.assert_array_equal(B.numpy(), GOLD["phase.B"].astype(np.int64))
