"""The PyTorch port's field layer against the JAX package's.

Same seeded numpy inputs (edge values 0, 1, m-2, m-1 included) through
`privacy_auction_tpu.ops.field` and `privacy_auction_tpu_torch.ops.field`,
for the base field p and the scalar field n: the canonical limbs must be
bit-identical, and equal to Python-int arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from privacy_auction_tpu.curves import SECP256K1 as JC
from privacy_auction_tpu.ops import field as JF
from privacy_auction_tpu_torch.curves import SECP256K1 as TC
from privacy_auction_tpu_torch.ops import field as TF

torch.set_num_threads(1)

FIELDS = {"p": (JC.fp, TC.fp), "n": (JC.fn, TC.fn)}


def _ints(m, seed, count=10):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(count, 8), dtype=np.uint64)
    vals = [sum(int(w) << (32 * j) for j, w in enumerate(row)) % m for row in words]
    return vals + [0, 1, m - 2, m - 1]


def _pair(xs):
    limbs = JF.ints_to_limbs(xs)
    return jnp.asarray(limbs), torch.as_tensor(limbs.astype(np.int64))


def _same(jax_out, torch_out, want=None):
    j = np.asarray(jax_out).astype(np.int64)
    t = torch_out.numpy()
    np.testing.assert_array_equal(t, j)
    if want is not None:
        assert [TF.limbs_to_int(r) for r in t] == want


OPS = {
    "add": (lambda F, s, a, b: F.add(s, a, b), lambda m, x, y: (x + y) % m),
    "sub": (lambda F, s, a, b: F.sub(s, a, b), lambda m, x, y: (x - y) % m),
    "neg": (lambda F, s, a, b: F.neg(s, a), lambda m, x, y: (-x) % m),
    "mul": (lambda F, s, a, b: F.mul(s, a, b), lambda m, x, y: x * y % m),
    "sqr": (lambda F, s, a, b: F.sqr(s, a), lambda m, x, y: x * x % m),
    "mul_small": (lambda F, s, a, b: F.mul_small(s, a, 21),
                  lambda m, x, y: 21 * x % m),
    "mul_small_vec": (
        lambda F, s, a, b: F.mul_small_vec(
            s, a[:12].reshape(3, 4, 16), [3, 21, 63]).reshape(12, 16),
        None),
    "inv": (lambda F, s, a, b: F.inv(s, a), lambda m, x, y: pow(x, m - 2, m)),
}
# the ops the slice's path runs in each field (scalar arithmetic mod n
# needs no inversion or small-constant muls)
FIELD_OPS = {"p": sorted(OPS), "n": ["add", "mul", "neg", "sub"]}


def _check_field_ops_match_jax(field):
    """Every op of the port's field layer, one jitted JAX program per field
    (its compile dominates the test's time)."""
    jspec, tspec = FIELDS[field]
    m = tspec.modulus
    xs, ys = _ints(m, 1), _ints(m, 2)[::-1]
    (ja, ta), (jb, tb) = _pair(xs), _pair(ys)
    jout = jax.jit(lambda a, b: {k: OPS[k][0](JF, jspec, a, b)
                                 for k in FIELD_OPS[field]})(ja, jb)
    for op in FIELD_OPS[field]:
        f, ref = OPS[op]
        _same(jout[op], f(TF, tspec, ta, tb),
              None if ref is None else [ref(m, x, y) for x, y in zip(xs, ys)])


def _check_from_random_bits_matches_jax():
    words = np.random.default_rng(4).integers(0, 1 << 32, size=(12, 8),
                                              dtype=np.uint64)
    words[0] = 0xFFFFFFFF                       # 2**256 - 1 wraps
    for jspec, tspec in FIELDS.values():
        _same(JF.from_random_bits(jspec, jnp.asarray(words.astype(np.uint32))),
              TF.from_random_bits(tspec, torch.as_tensor(words.astype(np.int64))))


def _check_bytes_and_wide_product_match_jax():
    xs = _ints(TC.fp.modulus, 5)
    ja, ta = _pair(xs)
    jb = np.asarray(JF.to_bytes_be(ja))
    tb = TF.to_bytes_be(ta)
    np.testing.assert_array_equal(tb.numpy(), jb)
    assert [bytes(r.tolist()) for r in tb] == [x.to_bytes(32, "big") for x in xs]
    np.testing.assert_array_equal(TF.from_bytes_be(tb).numpy(), ta.numpy())
    g = JC.glv.g1_limbs
    _same(JF._mul_raw(ja, jnp.broadcast_to(jnp.asarray(g), (len(xs), 10))),
          TF._mul_raw(ta, torch.as_tensor(g.astype(np.int64)).expand(len(xs), 10)),
          [x * JC.glv.g1 for x in xs])


def _check_random_draws_canonical_and_device_independent():
    g1 = torch.Generator().manual_seed(7)
    g2 = torch.Generator().manual_seed(7)
    a = TF.random(TC.fn, g1, (3, 5))
    b = TF.random(TC.fn, g2, (3, 5), device="cpu")
    assert a.shape == (3, 5, 16) and torch.equal(a, b)
    assert all(TF.limbs_to_int(r) < TC.fn.modulus for r in a.reshape(-1, 16))


# One test per file: pytest-xdist (--dist loadfile) queues files by test
# count, and one-test files go last, after the long-running files of the
# tier-1 run have been handed out (see ROADMAP.md, Queue 3).
def test_field_layer_matches_jax():
    """Both fields, the randomness seam, the byte codecs, the wide product
    and the generator draws."""
    for field in sorted(FIELDS):
        _check_field_ops_match_jax(field)
    _check_from_random_bits_matches_jax()
    _check_bytes_and_wide_product_match_jax()
    _check_random_draws_canonical_and_device_independent()
