"""The PyTorch port's SHA-256 against hashlib and the JAX package's."""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from privacy_auction_tpu.curves import SECP256K1 as JC
from privacy_auction_tpu.ops import sha256 as JS
from privacy_auction_tpu_torch.curves import SECP256K1 as TC
from privacy_auction_tpu_torch.ops import field as TF
from privacy_auction_tpu_torch.ops import sha256 as TS

torch.set_num_threads(1)


def _words(data: bytes):
    return np.frombuffer(hashlib.sha256(data).digest(), dtype=">u4").astype(np.int64)


# block-boundary lengths, and the Stage1 transcript's 1105 bytes (tag,
# generator, 15 points, id, step)
def _check_sha256_matches_hashlib(length):
    msgs = np.random.default_rng(length).integers(0, 256, size=(3, length),
                                                  dtype=np.uint8)
    got = TS.sha256(torch.as_tensor(msgs)).numpy()
    for i in range(3):
        np.testing.assert_array_equal(got[i], _words(msgs[i].tobytes()))


def _check_sha256_and_digest_to_scalar_match_jax():
    msgs = np.random.default_rng(9).integers(0, 256, size=(2, 4, 130),
                                             dtype=np.uint8)
    jd = jax.jit(JS.sha256)(jnp.asarray(msgs))
    td = TS.sha256(torch.as_tensor(msgs))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd).astype(np.int64))
    js = np.asarray(JS.digest_to_scalar(JC.fn, jd)).astype(np.int64)
    ts = TS.digest_to_scalar(TC.fn, td)
    np.testing.assert_array_equal(ts.numpy(), js)
    for i, m in enumerate(msgs.reshape(-1, 130)):
        h = int.from_bytes(hashlib.sha256(m.tobytes()).digest(), "big")
        assert TF.limbs_to_int(ts.reshape(-1, 16)[i]) == h % TC.fn.modulus


# One test per file: pytest-xdist (--dist loadfile) queues files by test
# count, and one-test files go last, after the long-running files of the
# tier-1 run have been handed out (see ROADMAP.md, Queue 3).
def test_sha256_matches_hashlib_and_jax():
    """Block-boundary lengths against hashlib; a batch against JAX."""
    for length in (0, 55, 56, 64, 119, 1105):
        _check_sha256_matches_hashlib(length)
    _check_sha256_and_digest_to_scalar_match_jax()
