"""The port's Barrett fields (NIST P-256's p and n,
`privacy_auction_tpu_torch/ops/field.py`) limb for limb against the JAX
package's (tests/data/torch_golden_p256.npz, from tools/torch_golden.py)
and against Python integers: mul, add, sub and inv of seeded and edge
values, `reduce_wide` of 512-bit values, and 16 random words a field
element (`from_random_bits`).  Tolerance 0."""

import pathlib

import numpy as np
import torch

from privacy_auction_tpu_torch.curves import get_curve
from privacy_auction_tpu_torch.ops import field as F

torch.set_num_threads(1)

GOLD = np.load(pathlib.Path(__file__).resolve().parent / "data"
               / "torch_golden_p256.npz")
CURVE = get_curve("P-256")


def _t(name):
    return torch.as_tensor(GOLD[name].astype(np.int64))


def _ints(t):
    return [F.limbs_to_int(row) for row in t.reshape(-1, t.shape[-1])]


def test_p256_fields_match_jax_and_python_ints():
    assert CURVE is get_curve("p256") and CURVE.name == "p256"
    for name in ("fp", "fn"):
        spec = getattr(CURVE, name)
        m = spec.modulus
        assert spec.mu_limbs is not None and F._fast_k0(spec) is None
        assert F.limbs_to_int(spec.mu_limbs) == (1 << 512) // m
        assert F.limbs_to_int(spec.m_limbs) == F.limbs_to_int(spec.m17_limbs) == m
        a, b = _t(f"{name}.a"), _t(f"{name}.b")
        xs, ys = _ints(a), _ints(b)
        got = {"mul": F.mul(spec, a, b), "add": F.add(spec, a, b),
               "sub": F.sub(spec, a, b), "inv": F.inv(spec, a)}
        want = {"mul": [x * y % m for x, y in zip(xs, ys)],
                "add": [(x + y) % m for x, y in zip(xs, ys)],
                "sub": [(x - y) % m for x, y in zip(xs, ys)],
                "inv": [pow(x, m - 2, m) if x else 0 for x in xs]}
        for op, out in got.items():
            np.testing.assert_array_equal(out.numpy(), _t(f"{name}.{op}").numpy(),
                                          err_msg=f"{name}.{op}")
            assert _ints(out) == want[op], f"{name}.{op}"
        wide = _t(f"{name}.wide")
        out = F.reduce_wide(spec, wide)
        np.testing.assert_array_equal(out.numpy(), _t(f"{name}.reduce_wide").numpy())
        assert _ints(out) == [x % m for x in _ints(wide)]
        words = _t(f"{name}.rand_words")
        out = F.from_random_bits(spec, words)
        np.testing.assert_array_equal(out.numpy(),
                                      _t(f"{name}.from_random_bits").numpy())
        assert _ints(out) == [sum(int(w) << (32 * j) for j, w in enumerate(row)) % m
                              for row in words.tolist()]
        assert F.random_words(spec) == 16
        # mul_small: the generic formulas' 3*t0 and 4*Y3
        for c in (3, 4):
            assert _ints(F.mul_small(spec, a, c)) == [c * x % m for x in xs]
