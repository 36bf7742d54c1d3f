"""Write the golden vectors that hold the PyTorch port to the JAX package.

    JAX_PLATFORMS=cpu python tools/torch_golden.py [--out tests/data/torch_golden_seal.npz]

Runs the JAX package (`privacy_auction_tpu`) on the CPU from seeded numpy
inputs and records, for a two-bidder, two-bit SEAL board: the random words
and the scalars they give, the commitments with their PoKDLog and PoWFCom
proofs, the round-1 keys with their PoKDLogs, the AV-net keys and both
ciphertext candidates, one Stage1 and one Stage2 proof, the nonces each
proof generator drew, Fiat-Shamir challenges, and the outcome of a verified
three-bidder auction.  `tests/test_torch_seal*.py` feed the same inputs and
nonces to the port and require the same bytes.

Why offline: compiling the JAX NIZK and SEAL code on the CPU is what makes
the repository's tier-1 test run slow.  With six pytest-xdist workers on an
8-core x86 CPU, tests/test_nizk.py took 449 s for 6 tests and
tests/test_seal.py 463 s for 7, in a run that took 1446 s of its 1470 s
limit.  The comparison is the same one a live test would make -- the JAX
function and its port counterpart on the same inputs -- with the JAX side's
compile time moved out of the tier-1 run.  Limb arrays are stored as
uint16.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("XLA_FLAGS", "--xla_backend_optimization_level=0 "
                      "--xla_llvm_disable_expensive_passes=true")
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from privacy_auction_tpu import nizk  # noqa: E402
from privacy_auction_tpu.curves import SECP256K1 as CURVE  # noqa: E402
from privacy_auction_tpu.ops import ec, field as F  # noqa: E402
from privacy_auction_tpu.protocols import seal  # noqa: E402

SEED = 20261016
BOARD_BIDS = (2, 3)          # bits [[1, 0], [1, 1]]: Stage1 at step 0, Stage2 at step 1
AUCTION_BIDS = (2, 1, 3)     # MSB set, so the auction runs Stage1 then Stage2
AUCTION_C = 2


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(pathlib.Path(__file__).resolve()
                                         .parents[1] / "tests" / "data"
                                         / "torch_golden_seal.npz"))
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    fn = CURVE.fn
    rng = np.random.default_rng(SEED)
    out = {}

    def words(name, shape):
        w = rng.integers(0, 1 << 32, size=shape + (8,), dtype=np.uint64)
        out[name + "_words"] = w.astype(np.uint32)
        s = F.from_random_bits(fn, jnp.asarray(w.astype(np.uint32)))
        out[name] = np.asarray(s)
        return s

    def put(prefix, tup):
        for k, v in tup._asdict().items():
            out[f"{prefix}.{k}"] = np.asarray(v)

    n, c = len(BOARD_BIDS), 2
    bits = jnp.asarray(seal.bids_to_bits(BOARD_BIDS, c))
    ids = jnp.arange(n, dtype=jnp.uint32)
    out["board_bids"] = np.asarray(BOARD_BIDS)
    out["seed"] = np.asarray(SEED)

    # ---- commit phase ------------------------------------------------------
    alpha = words("alpha", (n, c))
    beta = words("beta", (n, c))
    v = words("commit_v", (2, n, c))
    exp_phi = F.add(fn, F.mul(fn, alpha, beta),
                    jnp.zeros((n, c, 16), jnp.uint32).at[..., 0].set(bits))
    pts = jax.jit(lambda k: ec.mul_base(CURVE, k))(
        jnp.stack([exp_phi, alpha, beta, v[0], v[1]]))
    phi, A, B = pts[0], pts[1], pts[2]
    out["phi"], out["A"], out["B"] = map(np.asarray, (phi, A, B))
    ids_nc = jnp.broadcast_to(ids[:, None], (n, c))
    steps_nc = jnp.broadcast_to(jnp.arange(c, dtype=jnp.uint32), (n, c))
    pok = jax.jit(lambda v, e, X, x, i, s: nizk.gen_pokdlog_from(
        CURVE, v, e, X, x, i, s))(
        v, pts[3:5], jnp.stack([A, B]), jnp.stack([alpha, beta]),
        jnp.broadcast_to(ids_nc, (2, n, c)), jnp.broadcast_to(steps_nc, (2, n, c)))
    put("commit_pok", pok)
    out["commit_pok_ch"] = np.asarray(nizk.fs_challenge(
        CURVE, [pok.eps, jnp.stack([A, B])], jnp.broadcast_to(ids_nc, (2, n, c)),
        nizk.TAG_POKDLOG, jnp.broadcast_to(steps_nc, (2, n, c))))
    k_wf = jax.random.key(SEED + 1)
    out["powf_r"] = np.asarray(F.random(fn, k_wf, (3, n, c)))
    powf = jax.jit(lambda *a: nizk.gen_powfcom(CURVE, k_wf, *a))(
        phi, A, B, alpha, bits, ids_nc, steps_nc)
    put("powf", powf)

    # ---- round 1, AV-net keys, ciphertext candidates -----------------------
    xr = words("r1_xr", (2, c, n))
    v1 = words("r1_v", (2, c, n))
    pts4 = jax.jit(lambda k: ec.mul_base(CURVE, k))(jnp.concatenate([xr, v1]))
    X, R = pts4[0], pts4[1]
    steps_cn = jnp.broadcast_to(jnp.arange(c, dtype=jnp.uint32)[None, :, None],
                                (2, c, n))
    pok1 = jax.jit(lambda v, e, X, x, i, s: nizk.gen_pokdlog_from(
        CURVE, v, e, X, x, i, s))(v1, pts4[2:], pts4[:2], xr,
                                  jnp.broadcast_to(ids, (2, c, n)), steps_cn)
    out["X"], out["R"] = np.asarray(X), np.asarray(R)
    put("r1_pok", pok1)
    Y = jax.jit(lambda X: seal.avnet_keys_steps(CURVE, X))(X)
    b01 = jax.jit(lambda Y, R, x: seal._b01(CURVE, Y, R, x))(Y, R, xr[0])
    out["Y"], out["b01"] = np.asarray(Y), np.asarray(b01)
    x_all = xr[0]

    # ---- step 0: Stage1 ------------------------------------------------------
    d0 = bits[:, 0]
    b_0 = ec.select(d0 == 0, b01[0, 0], b01[1, 0])
    k_s1 = jax.random.key(SEED + 2)
    out["stage1_r"] = np.asarray(F.random(fn, k_s1, (5, n)))
    proof1, _ = jax.jit(lambda *a: nizk.gen_powfstage1(
        CURVE, k_s1, *a[:10], 0, b=a[10]))(
        X[0], Y[0], R[0], phi[:, 0], A[:, 0], B[:, 0], x_all[0], alpha[:, 0],
        d0, ids, b_0)
    put("stage1", proof1)
    out["stage1_b"] = np.asarray(b_0)

    # ---- step 1: Stage2 (step 0 decided with d0 = [1, 1]) ---------------------
    d1 = bits[:, 1] & d0
    b_1 = ec.select(d1 == 0, b01[0, 1], b01[1, 1])
    pts2 = dict(Xi=X[1], Ri=R[1], Yi=Y[1], Bj=b_0, Xj=X[0], Rj=R[0], Yj=Y[0],
                Ci=phi[:, 1], A=A[:, 1], B=B[:, 1])
    k_s2 = jax.random.key(SEED + 3)
    out["stage2_r"] = np.asarray(F.random(fn, k_s2, (14, n)))
    proof2, _ = jax.jit(lambda p, *a: nizk.gen_powfstage2(
        CURVE, k_s2, p, *a[:5], ids, 1, b=a[5]))(
        pts2, x_all[1], x_all[0], alpha[:, 1], d1, d0, b_1)
    put("stage2", proof2)
    out["stage2_b"] = np.asarray(b_1)

    # ---- a whole verified auction --------------------------------------------
    res = seal.run_auction(CURVE, jax.random.key(SEED + 4), list(AUCTION_BIDS),
                           AUCTION_C, verify=True)
    out["auction_bids"] = np.asarray(AUCTION_BIDS)
    out["auction_c"] = np.asarray(AUCTION_C)
    out["auction_max_bid"] = np.asarray(res.max_bid)
    out["auction_verified"] = np.asarray(res.verified)
    out["auction_deciding_bits"] = np.asarray(res.deciding_bits)

    packed = {}
    for k, val in out.items():
        val = np.asarray(val)
        if val.dtype == np.uint32 and not k.endswith("_words"):
            if int(val.max(initial=0)) >= (1 << 16):
                raise ValueError(f"{k}: not 16-bit limbs")
            val = val.astype(np.uint16)
        packed[k] = val
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out, **packed)
    print(f"wrote {args.out}: {len(packed)} arrays, "
          f"{pathlib.Path(args.out).stat().st_size} bytes")


if __name__ == "__main__":
    main()
