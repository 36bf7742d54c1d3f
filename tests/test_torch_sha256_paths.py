"""The port's plain SHA-256 at every message length the paths hash,
against hashlib and the JAX package's `sha256`.

tools/torch_golden.py hashed three seeded messages a length with the JAX
package's `sha256` (tests/data/torch_golden_sha256.npz): the PoKDLog,
PoWFCom, Stage1 and Stage2 transcripts (218, 543, 1066 and 1846 bytes),
CCS22's bidder and evaluator messages at 4x3 (384 and 768 bytes), and the
block boundaries 0, 55, 56, 63, 64 and 119.  On the CPU `sha256` takes the
plain version (on the card, the kernel; chip_smoke.py holds it to this
version and to hashlib there).  The lengths are those the port's own code
builds, recorded through a spy on the plain version: `fs_challenge` at
each proof's tag and point count (2, 7, 15 and 27 points) with a step, and
a CCS22 setup at 4x3 with its ladders stubbed."""

import collections
import hashlib
import pathlib

import numpy as np
import torch

from privacy_auction_tpu_torch import nizk
from privacy_auction_tpu_torch.curves import SECP256K1 as C
from privacy_auction_tpu_torch.ops import sha256 as S
from privacy_auction_tpu_torch.protocols import ccs22

torch.set_num_threads(1)

GOLD = np.load(pathlib.Path(__file__).resolve().parent / "data"
               / "torch_golden_sha256.npz")
LENGTHS = [int(v) for v in GOLD["lengths"]]


def _hashed_lengths(monkeypatch):
    """The message lengths of the PoKDLog, PoWFCom, Stage1 and Stage2
    transcripts (each with its step, as the auctions bind them) and of a
    CCS22 setup at 4x3 (bidders, evaluator),
    as the port builds them, recorded through a spy on the plain version."""
    seen = collections.Counter()
    real = S.sha256_plain

    def spy(msg):
        seen[msg.shape[-1]] += 1
        return real(msg)

    monkeypatch.setattr(S, "sha256_plain", spy)
    P = torch.zeros((1, 3, 16), dtype=torch.int64)
    ids = torch.zeros((1,), dtype=torch.int64)
    for pts, tag, steps in (([P] * 2, nizk.TAG_POKDLOG, 0),
                            ([P] * 7, nizk.TAG_POWFCOM, 0),
                            ([P] * 15, nizk.TAG_STAGE1, 0),
                            ([P] * 27, nizk.TAG_STAGE2, 0)):
        nizk.fs_challenge(C, pts, ids, tag, steps)
    n, c = 4, 3
    gen = torch.Generator().manual_seed(5)
    sec = ccs22.draw_setup(C, gen, n, c, "cpu")
    pp = ccs22.pp_or_make(C, "cpu")
    betas = sec.x                     # any (n, c) scalars: only their bytes
    monkeypatch.setattr(ccs22.ec, "mul_base", lambda curve, k: torch.zeros(
        k.shape[:-1] + (3, 16), dtype=torch.int64))
    monkeypatch.setattr(ccs22.ec, "mul_comb", lambda curve, t, k: torch.zeros(
        k.shape[:-1] + (3, 16), dtype=torch.int64))
    ccs22.setup_from(C, pp, sec.rcom, sec, 0, betas)
    return seen


def test_plain_sha256_matches_hashlib_and_jax_at_path_lengths(monkeypatch):
    seen = _hashed_lengths(monkeypatch)
    assert sorted(seen) == sorted(LENGTHS[:6]), seen
    assert set(LENGTHS) >= {0, 55, 56, 63, 64, 119}
    for length in LENGTHS:
        msgs = GOLD[f"msg{length}"]
        got = S.sha256(torch.as_tensor(msgs))
        assert got.dtype == torch.int64 and got.shape == (3, 8)
        np.testing.assert_array_equal(
            got.numpy(), GOLD[f"digest{length}_words"].astype(np.int64),
            err_msg=f"JAX sha256 at {length} bytes")
        for i, m in enumerate(msgs):
            want = np.frombuffer(hashlib.sha256(m.tobytes()).digest(), ">u4")
            np.testing.assert_array_equal(got[i].numpy(), want.astype(np.int64),
                                          err_msg=f"hashlib at {length} bytes")
