"""Write the golden vectors that hold the PyTorch port to the JAX package.

    JAX_PLATFORMS=cpu python tools/torch_golden.py \
        [--only seal ccs22 ladders64 seal_metered ccs22_metered wire p256
                seal_step ccs22_step sha256]

Runs the JAX package (`privacy_auction_tpu`) on the CPU from seeded inputs
and writes `tests/data/torch_golden_<name>.npz` for each name (all of them by
default); `seal_metered` and `ccs22_metered` share
`torch_golden_metered.npz`, and running one of them keeps the other's
arrays there.

`seal` records, for a two-bidder, two-bit SEAL board: the random words
and the scalars they give, the commitments with their PoKDLog and PoWFCom
proofs, the round-1 keys with their PoKDLogs, the AV-net keys and both
ciphertext candidates, one Stage1 and one Stage2 proof, the nonces each
proof generator drew, Fiat-Shamir challenges, and the outcome of a verified
three-bidder auction.  `tests/test_torch_seal*.py` feed the same inputs and
nonces to the port and require the same bytes.

`ccs22` records the CRS (g1, h and a digest of each comb table), and for a
three-bidder, two-bit CCS22 auction every scalar the JAX driver drew (OT
betas, the setup secrets x, r, s, t and the commitment blinding, the
evaluator's OT nonces and the senders' dummy messages), the setup messages
at evaluators 0 and 2, the precomputed point streams, each step's OT
messages and announced bit, and `max_bid`; the per-phase functions
(`setup`, `bes_encode`, one OT round trip at each choice bit) with their
nonces; and the drawn scalars and outcome of the edge-bid auctions of
tests/test_ccs22.py.  `tests/test_torch_ccs22*.py` feed the port the same
scalars and require the same limbs.

`ladders64` records the TPU kernels that only the kernel validator reaches
(`pallas_ec.scalar_mul`, `dual_mul` at 64 windows, `base_mul_add`, and one
`_pt_add_kernel` pass) in Pallas interpret mode at the validator's edge
lanes, beside the JAX package's plain XLA ladders for a curve without GLV.
`tests/test_torch_ec_*64.py` hold the port's plain versions to them.

`seal_metered` records the role-metered SEAL host loop (`run_auction` with
a `TimeTracker`) at bids [5, 3, 6], c = 3, the bids of
tests/test_adversarial.py: the outcome and deciding bits, the
`DataTracker` bytes per category, the `(phase, step, proof1 is None,
proof2 is None)` calls an identity `tamper` hook sees, the checks the loop
ran with their results, and for each of that file's five tamper cases the
outcome and the check that aborted the auction.  `ccs22_metered` records
the role-metered CCS22 driver at bids [2, 1, 3, 0], c = 2, evaluator 0:
the outcome, deciding bits and bytes per category.
`tests/test_torch_seal_tamper*.py` and `tests/test_torch_ccs22_metered.py`
hold the port's metered drivers to them.

`wire` records the JAX package's `runtime/wire.py` bytes (`pack`) and sizes
(`wire_size`) of four board messages built from the `seal` file's limbs:
the two-bidder commitment, bidder 0's round-one keys at step 1, the
Stage1 round two of both bidders and bidder 1's Stage2 round two.  It
reads `torch_golden_seal.npz`, so it runs after `seal`.
`tests/test_torch_wire.py` holds the port's wire module to them.

`seal_step` records SEAL's fused step at bids [5, 3, 6], c = 3 (Stage1 at
step 0, the junction there, Stage2 at steps 1 and 2): the commitments,
the precomputed streams `_precompute` gives the scan, and for each step
what the JAX package's scan body (`_scan_steps`) took and gave -- the
carried race, junction and previous deciding step, its per-step key's
stage nonces, the new carry, the deciding bit and the proof check --
with the proof the body generated; the scan's deciding bits and checks;
then `full_step` at step 0 (Stage1) and step 1 (Stage2, against step 0
of the scan), `step_stage1`, and `step_stage2` against `step_stage1`'s
outputs, each with the nonces its key gave and all it returned; and
`ec.serialize_affine` of seeded affine points with infinity.  The scan
body is recorded through a stand-in for `jax.lax.scan` that runs the
body, jitted, one step at a time (this process only).
`tests/test_torch_seal_step_body.py` and `test_torch_seal_full_step.py`
hold the port's `step_body`, `full_step`, `step_stage1`, `step_stage2` and
`serialize_affine` to them.

`ccs22_step` records CCS22's fused steps at bids [5, 3, 2, 6], c = 3
(every lane's effective bit and the race change from step to step): the
scalars the JAX driver drew, the precomputed point streams `_precompute`
gives the step scan, and for the evaluator at lane 0 and at the last lane
the scan's (`_jit_scan_steps`) announced bits, OTR1 and OTS, step-major.
`tests/test_torch_ccs22_step_body.py` holds the port's `step_body`, run
a step at a time, and its uncaptured steps to them.

`sha256` records the JAX package's `sha256` (jitted) of seeded messages at
every length the paths hash at small sizes -- the PoKDLog, PoWFCom, Stage1
and Stage2 transcripts (218, 543, 1066 and 1846 bytes) and CCS22's bidder
and evaluator messages at 4x3 (384 and 768 bytes) -- and at the block
boundaries 0, 55, 56, 63, 64 and 119; three messages a length.
`tests/test_torch_sha256_paths.py` holds the port's plain SHA-256 to them
and to hashlib.

`p256` records NIST P-256 on the JAX package's generic path (Barrett
fields, RCB16 Alg 1/3, 64-window ladders, no Pallas): for both fields
mul, add, sub and inv of seeded values with edge values, the reduction of
512-bit values (`reduce_wide`) and of 16 random words (`from_random_bits`);
on the curve `add` and `dbl` with infinity, P + P and P + (-P) lanes, and
`scalar_mul`, `mul_base`, `dual_mul` and `base_mul_add` at k = 0, 1, n - 1
and seeded scalars, as projective limbs.  `tests/test_torch_p256_*.py`
hold the port's plain path to them.

Times on an 8-core x86 CPU: `seal_metered` and `ccs22_metered` together
took 6 min 32 s of wall time (another process shared the CPU for part
of it).

Why offline: compiling the JAX NIZK and SEAL code on the CPU is what makes
the repository's tier-1 test run slow (and interpreting a 64-window Pallas
ladder takes minutes).  With six pytest-xdist workers on an
8-core x86 CPU, tests/test_nizk.py took 449 s for 6 tests and
tests/test_seal.py 463 s for 7, in a run that took 1446 s of its 1470 s
limit.  The comparison is the same one a live test would make -- the JAX
function and its port counterpart on the same inputs -- with the JAX side's
compile time moved out of the tier-1 run.  Limb arrays are stored as
uint16.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import os
import pathlib
import random
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
from privacy_auction_tpu.ops import pallas_ec as PE  # noqa: E402
from privacy_auction_tpu.protocols import ccs22, seal  # noqa: E402
from privacy_auction_tpu.utils import trackers as T  # noqa: E402

SEED = 20261016
BOARD_BIDS = (2, 3)          # bits [[1, 0], [1, 1]]: Stage1 at step 0, Stage2 at step 1
AUCTION_BIDS = (2, 1, 3)     # MSB set, so the auction runs Stage1 then Stage2
AUCTION_C = 2
CCS22_BIDS = (2, 1, 3)       # bits [[1, 0], [0, 1], [1, 1]]
CCS22_C = 2
CCS22_EVALS = (0, 2)
CCS22_EDGE = ((0, 0, 0), (5, 5, 5), (7, 1, 2))   # tests/test_ccs22.py:74
CCS22_EDGE_C = 3
METERED_BIDS = (5, 3, 6)     # tests/test_adversarial.py: step 1 runs Stage2
METERED_C = 3
CCS22_METERED_BIDS = (2, 1, 3, 0)
CCS22_METERED_C = 2
# the check names the metered drivers of both packages run
CHECKS = ("verify_commit", "verify_round_one", "verify_round_two")
HOOK_PHASES = ("commit", "round1", "round2")
TAMPER_CASES = ("phi", "round1_x", "stage1_b", "stage2_b", "stage2_ch2")
SEAL_CATEGORIES = (T.CATEGORY_BIDDER, T.CATEGORY_VERIFIER)
CCS22_CATEGORIES = (T.CATEGORY_BIDDER, T.CATEGORY_EVALUATOR,
                    T.CATEGORY_BIDDER_AND_EVALUATOR)
DATA = pathlib.Path(__file__).resolve().parents[1] / "tests" / "data"


def seal_arrays():
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
    return out


def ccs22_draws(key, n, c):
    """Every scalar `ccs22._run_fused` draws from `key`, in its key order."""
    fn = CURVE.fn
    keys = jax.random.split(key, 4)
    k_sec, k_rcom = jax.random.split(keys[1])
    sec4 = F.random(fn, k_sec, (4, n, c))
    return dict(beta=F.random(fn, keys[0], (n, c)), x=sec4[0], r=sec4[1],
                s=sec4[2], t=sec4[3], rcom=F.random(fn, k_rcom, (n,)),
                k_rand=F.random(fn, keys[2], (n, c)),
                m1k=F.random(fn, keys[3], (n, c)))


def ccs22_arrays():
    fn = CURVE.fn
    out = {}

    def put(prefix, tup):
        for k, v in tup._asdict().items():
            out[f"{prefix}.{k}"] = np.asarray(v)

    # ---- CRS ----------------------------------------------------------------
    pp = ccs22.make_pub_params(CURVE)
    out["crs.g1"], out["crs.h"] = np.asarray(pp.g1), np.asarray(pp.h)
    for name in ("g1_table", "h_table"):
        raw = np.ascontiguousarray(np.asarray(getattr(pp, name)).astype("<u2"))
        out[f"crs.{name}_sha256"] = np.frombuffer(
            hashlib.sha256(raw.tobytes()).digest(), np.uint8)

    # ---- one fused auction at two evaluators --------------------------------
    bids = list(CCS22_BIDS)
    n, c = len(bids), CCS22_C
    bits = jnp.asarray(seal.bids_to_bits(bids, c))
    bid_scalars = jnp.asarray(F.ints_to_limbs(bids))
    key = jax.random.key(SEED + 10)
    draws = ccs22_draws(key, n, c)
    for k, v in draws.items():
        out[f"draw.{k}"] = np.asarray(v)
    out["bids"], out["c"], out["seed"] = np.asarray(bids), np.asarray(c), np.asarray(SEED)
    out["evals"] = np.asarray(CCS22_EVALS)
    keys = jax.random.split(key, 4)
    for eid in CCS22_EVALS:
        pub, sec = ccs22._jit_setup(CURVE, keys[1], pp, bid_scalars, c,
                                    jnp.asarray(eid, jnp.int32), draws["beta"])
        put(f"e{eid}.setup_pub", pub)
        announced, r1, ots = ccs22._run_fused(CURVE, key, pp, bid_scalars,
                                              bits, eid)
        out[f"e{eid}.announced"] = np.asarray(announced)
        put(f"e{eid}.otr1", r1)
        put(f"e{eid}.ots", ots)
        res = ccs22.run_auction(CURVE, key, bids, c, eid)
        out[f"e{eid}.max_bid"] = np.asarray(res.max_bid)
        out[f"e{eid}.deciding_bits"] = np.asarray(res.deciding_bits)
    pre = ccs22._precompute(CURVE, keys[2:4], pp, pub.X, sec, draws["beta"])
    for name, v in zip(("enc0", "enc1", "T2", "M1", "gb", "hb", "z", "bz", "E",
                        "m0a"), pre):
        out[f"pre.{name}"] = np.asarray(v)

    # ---- the per-phase functions of the metered driver ------------------------
    d = bits[:, 0]
    B = jax.jit(lambda *a: ccs22.bes_encode(CURVE, *a))(
        pub.X[:, 0], draws["x"][:, 0], draws["r"][:, 0], d)
    out["phase.d"], out["phase.B"] = np.asarray(d), np.asarray(B)
    for eid in (0, 1):            # choice bits alpha = d[0] = 1, d[1] = 0
        k_r1, k_s = jax.random.split(jax.random.key(SEED + 20 + eid))
        out[f"ot{eid}.k"] = np.asarray(F.random(fn, k_r1, (n,)))
        out[f"ot{eid}.m1k"] = np.asarray(F.random(fn, k_s, (n,)))
        r1 = ccs22._jit_otr1(CURVE, k_r1, pp, draws["beta"][:, 0], d[eid])
        ots = ccs22._jit_ots(CURVE, k_s, pp, r1, B, draws["s"][:, 0],
                             draws["t"][:, 0])
        ann = ccs22._jit_otr2(CURVE, ots, draws["beta"][:, 0], B, d, eid)
        put(f"ot{eid}.otr1", r1)
        put(f"ot{eid}.ots", ots)
        out[f"ot{eid}.announced"] = np.asarray(ann)

    # ---- edge bids (tests/test_ccs22.py) ----------------------------------------
    for i, ebids in enumerate(CCS22_EDGE):
        key = jax.random.key(10)
        for k, v in ccs22_draws(key, len(ebids), CCS22_EDGE_C).items():
            out[f"edge{i}.draw.{k}"] = np.asarray(v)
        res = ccs22.run_auction(CURVE, key, list(ebids), CCS22_EDGE_C, 0)
        out[f"edge{i}.bids"] = np.asarray(ebids)
        out[f"edge{i}.max_bid"] = np.asarray(res.max_bid)
        out[f"edge{i}.deciding_bits"] = np.asarray(res.deciding_bits)
    return out


def ladders64_arrays():
    """The validator's direct ladders in Pallas interpret mode, plus the
    JAX package's XLA ladders on a copy of secp256k1 that has no GLV
    parameters (the path `ec.scalar_mul` / `dual_mul` / `base_mul_add` take
    on such a curve)."""
    host = CURVE.host
    rng = random.Random(SEED)
    ks = [0, 1, host.n - 1, rng.randrange(host.n)]
    ts = [1, 0, rng.randrange(host.n), rng.randrange(host.n)]
    Ps = [host.mul(rng.randrange(1, host.n), host.g) for _ in ks]
    Qs = [host.mul(rng.randrange(1, host.n), host.g) for _ in ks]
    Ps[2] = Qs[2] = None                 # the point-at-infinity input lane
    k, t = jnp.asarray(F.ints_to_limbs(ks)), jnp.asarray(F.ints_to_limbs(ts))
    P = jnp.asarray(ec.encode_host_points(Ps))
    Q = jnp.asarray(ec.encode_host_points(Qs))
    out = {"k": np.asarray(k), "t": np.asarray(t), "P": np.asarray(P),
           "Q": np.asarray(Q)}

    PE._INTERPRET = True
    out["pallas.scalar_mul"] = np.asarray(jax.jit(
        lambda P, k: PE.scalar_mul(CURVE, P, k))(P, k))
    out["pallas.dual_mul"] = np.asarray(jax.jit(
        lambda P, k, Q, t: PE.dual_mul(CURVE, P, k, Q, t))(P, k, Q, t))
    out["pallas.base_mul_add"] = np.asarray(jax.jit(
        lambda s, P, t: PE.base_mul_add(CURVE, s, P, t))(k, P, t))
    # pt_add lanes: P+Q, P+P, P+(-P), P+inf, inf+Q
    A = jnp.stack([P[0], P[1], P[3], P[0], P[2]])
    Bq = jnp.stack([Q[0], P[1], ec.neg(CURVE, P[3]), P[2], Q[1]])
    nl = A.shape[0]
    out["add.P"], out["add.Q"] = np.asarray(A), np.asarray(Bq)
    out["pallas.pt_add"] = np.asarray(jax.jit(lambda A, Bq: PE._from_rows_pt(
        PE._grid_call(PE._pt_add_kernel, CURVE, nl,
                      [PE._to_rows_pt(A, nl), PE._to_rows_pt(Bq, nl)], (2, 2),
                      const_inputs=(PE._mc(CURVE),)), nl))(A, Bq))
    PE._INTERPRET = False

    nog = dataclasses.replace(CURVE, name="secp256k1-without-glv")
    nog.__dict__["glv"] = None
    out["xla.scalar_mul"] = np.asarray(jax.jit(
        lambda P, k: ec.scalar_mul(nog, P, k))(P, k))
    out["xla.dual_mul"] = np.asarray(jax.jit(
        lambda P, k, Q, t: ec.dual_mul(nog, P, k, Q, t))(P, k, Q, t))
    out["xla.base_mul_add"] = np.asarray(jax.jit(
        lambda s, P, t: ec.base_mul_add(nog, s, P, t))(k, P, t))
    out["xla.pt_add"] = np.asarray(jax.jit(
        lambda A, Bq: ec.add(CURVE, A, Bq))(A, Bq))
    return out


def _bump(P, *idx):
    """P with P[idx] replaced by P[idx] + G (tests/test_adversarial.py)."""
    g = jnp.asarray(CURVE.comb_table[0, 1])
    return P.at[idx].set(ec.add(CURVE, P[idx], g))


def _tamper(case):
    """The tamper hooks of tests/test_adversarial.py, by case name."""
    def hook(phase, step, pub):
        if case == "phi" and phase == "commit":
            return pub._replace(phi=_bump(pub.phi, 0, 0))
        if case == "round1_x" and phase == "round1" and step == 0:
            return pub._replace(X=_bump(pub.X, 1))
        if case == "stage1_b" and phase == "round2" and step == 0:
            return pub._replace(b=_bump(pub.b, 0))
        if case == "stage2_b" and phase == "round2" and step == 1:
            return pub._replace(b=_bump(pub.b, 2))
        if case == "stage2_ch2" and phase == "round2" and step == 1:
            p2 = pub.proof2
            return pub._replace(proof2=p2._replace(
                ch2=p2.ch2.at[..., 0].set(p2.ch2[..., 0] ^ 1)))
        return pub
    return hook


def seal_metered_arrays():
    """The role-metered SEAL loop: the checks it runs are recorded through
    wrappers of the module's jitted check functions (this process only)."""
    checks = []

    def recorded(name, fn, step_arg):
        def run(*a):
            ok = fn(*a)
            step = -1 if step_arg is None else int(a[step_arg])
            checks.append((CHECKS.index(name), step, int(np.asarray(ok).all())))
            return ok
        return run

    seal._jit_verify_commit = recorded("verify_commit", seal._jit_verify_commit,
                                       None)
    seal._jit_verify_round_one = recorded(
        "verify_round_one", seal._jit_verify_round_one, 3)
    seal._jit_verify_round_two_s1 = recorded(
        "verify_round_two", seal._jit_verify_round_two_s1, 6)
    seal._jit_verify_round_two_s2 = recorded(
        "verify_round_two", seal._jit_verify_round_two_s2, 7)

    bids, c = list(METERED_BIDS), METERED_C
    key = jax.random.key(SEED + 30)
    out = {"seal.bids": np.asarray(bids), "seal.c": np.asarray(c),
           "seal.categories": np.asarray(SEAL_CATEGORIES),
           "checks": np.asarray(CHECKS), "hook_phases": np.asarray(HOOK_PHASES),
           "tamper_cases": np.asarray(TAMPER_CASES)}
    hook_calls = []

    def identity(phase, step, pub):
        hook_calls.append((HOOK_PHASES.index(phase),
                           -1 if step is None else step,
                           int(getattr(pub, "proof1", None) is None),
                           int(getattr(pub, "proof2", None) is None)))
        return pub

    data = T.DataTracker()
    res = seal.run_auction(CURVE, key, bids, c, verify=True,
                           trackers=T.SealCommTracker(data),
                           tamper=identity, times=T.TimeTracker())
    out["seal.max_bid"] = np.asarray(res.max_bid)
    out["seal.verified"] = np.asarray(res.verified)
    out["seal.deciding_bits"] = np.asarray(res.deciding_bits)
    out["seal.bytes"] = np.asarray(
        [data._acc[k] for k in SEAL_CATEGORIES], np.int64)
    out["seal.hook_calls"] = np.asarray(hook_calls, np.int64)
    out["seal.checks"] = np.asarray(checks, np.int64)
    for case in TAMPER_CASES:
        checks.clear()
        res = seal.run_auction(CURVE, key, bids, c, verify=True,
                               tamper=_tamper(case))
        out[f"tamper.{case}.max_bid"] = np.asarray(res.max_bid)
        out[f"tamper.{case}.verified"] = np.asarray(res.verified)
        # the last check run is the one that failed
        out[f"tamper.{case}.abort"] = np.asarray(checks[-1], np.int64)
    return out


def ccs22_metered_arrays():
    bids, c = list(CCS22_METERED_BIDS), CCS22_METERED_C
    data = T.DataTracker()
    res = ccs22.run_auction(CURVE, jax.random.key(SEED + 40), bids, c, 0,
                            trackers=T.Ccs22CommTracker(data),
                            times=T.TimeTracker())
    return {"ccs22.bids": np.asarray(bids), "ccs22.c": np.asarray(c),
            "ccs22.eval_id": np.asarray(0),
            "ccs22.categories": np.asarray(CCS22_CATEGORIES),
            "ccs22.max_bid": np.asarray(res.max_bid),
            "ccs22.deciding_bits": np.asarray(res.deciding_bits),
            "ccs22.bytes": np.asarray([data._acc[k] for k in CCS22_CATEGORIES],
                                      np.int64)}


def wire_arrays():
    from privacy_auction_tpu.runtime import wire

    gold = np.load(DATA / "torch_golden_seal.npz")

    def u(name):
        return jnp.asarray(gold[name].astype(np.uint32))

    def fields(cls, prefix, idx):
        return cls(**{f: u(f"{prefix}.{f}")[idx] for f in cls._fields})

    lane1 = slice(1, 2)
    pok_c = u("commit_pok.eps"), u("commit_pok.rho")      # (a/b, n, c, ...)
    pok_1 = u("r1_pok.eps"), u("r1_pok.rho")              # (x/r, c, n, ...)
    msgs = {
        "commit": seal.CommitmentPub(
            phi=u("phi"), A=u("A"), B=u("B"),
            pok_a=nizk.PoKDLog(pok_c[0][0], pok_c[1][0]),
            pok_b=nizk.PoKDLog(pok_c[0][1], pok_c[1][1]),
            powf=fields(nizk.PoWFCom, "powf", slice(None))),
        "round1": seal.RoundOnePub(
            X=u("X")[1, 0:1], R=u("R")[1, 0:1],
            pok_x=nizk.PoKDLog(pok_1[0][0, 1, 0:1], pok_1[1][0, 1, 0:1]),
            pok_r=nizk.PoKDLog(pok_1[0][1, 1, 0:1], pok_1[1][1, 1, 0:1])),
        "stage1": seal.RoundTwoPub(
            b=u("stage1_b"), proof1=fields(nizk.PoWFStage1, "stage1",
                                           slice(None)), proof2=None),
        "stage2": seal.RoundTwoPub(
            b=u("stage2_b")[lane1], proof1=None,
            proof2=fields(nizk.PoWFStage2, "stage2", lane1)),
    }
    out = {}
    for name, msg in msgs.items():
        data = wire.pack(CURVE, msg)
        out[f"wire.{name}"] = np.frombuffer(data, np.uint8)
        out[f"wire.{name}.size"] = np.asarray(wire.wire_size(msg))
    return out


STEP_BIDS = (5, 3, 6)        # bits 101, 011, 110: Stage1, then Stage2 twice
STEP_C = 3


def _stage_r(key, stage2, n):
    """The nonces gen_powfstage1 / gen_powfstage2 draw from `key`."""
    return F.random(CURVE.fn, key, ((14 if stage2 else 5), n))


def _step_draws(key, stage2, n):
    """The nonces `full_step` draws from `key`: round one's keys and
    PoKDLog nonces, then the stage proof's."""
    k1, k2 = jax.random.split(key)
    k_xr, k_v = jax.random.split(k1)
    return (F.random(CURVE.fn, k_xr, (2, n)), F.random(CURVE.fn, k_v, (2, n)),
            _stage_r(k2, stage2, n))


def seal_step_arrays():
    fn = CURVE.fn
    out = {}

    def put(prefix, tup):
        for k, v in tup._asdict().items():
            if hasattr(v, "_asdict"):
                put(f"{prefix}.{k}", v)
            else:
                out[f"{prefix}.{k}"] = np.asarray(v)

    bids, c = list(STEP_BIDS), STEP_C
    n = len(bids)
    bits = jnp.asarray(seal.bids_to_bits(bids, c))
    ids = jnp.arange(n, dtype=jnp.uint32)
    out["bids"], out["c"] = np.asarray(bids), np.asarray(c)
    commit_pub, commit_sec = seal._jit_commit(CURVE, jax.random.key(SEED + 50),
                                              bits, ids)
    put("commit_pub", commit_pub)
    put("commit_sec", commit_sec)
    pre = seal._precompute(CURVE, jax.random.key(SEED + 51), (n, c), ids,
                           True)
    step_keys, X_all, R_all, x_all, Y_all, b0, b1, _ = pre
    for name, v in zip(("X", "R", "x", "Y", "b0", "b1"),
                       (X_all, R_all, x_all, Y_all, b0, b1)):
        out[f"pre.{name}"] = np.asarray(v)

    # ---- the scan body, one step at a time ----------------------------------
    steps = []

    def recording_scan(body, init, xs=None, **kw):
        if getattr(body, "__qualname__", "") != "_scan_steps.<locals>.body":
            return real_scan(body, init, xs, **kw)     # the ladders' scans
        run = jax.jit(body)
        carry, ys = init, []
        for i in range(len(xs[0])):
            x = jax.tree.map(lambda a: a[i], xs)
            new, y = run(carry, x)
            steps.append((carry, x, new, y))
            carry, ys = new, ys + [y]
        return carry, jax.tree.map(lambda *a: jnp.stack(a), *ys)

    real_scan = jax.lax.scan
    jax.lax.scan = recording_scan
    try:
        deciding, oks = seal._scan_steps(CURVE, pre, bits, ids, commit_pub,
                                         commit_sec, True)
    finally:
        jax.lax.scan = real_scan
    out["scan.deciding"], out["scan.oks"] = np.asarray(deciding), np.asarray(oks)
    gen1 = jax.jit(lambda k, *a: nizk.gen_powfstage1(CURVE, k, *a[:10], a[10],
                                                     b=a[11]))
    gen2 = jax.jit(lambda k, p, *a: nizk.gen_powfstage2(CURVE, k, p, *a[:5],
                                                        a[5], a[6], b=a[7]))
    for s_, ((race, junction, prev), x, (new_race, new_junction, new_prev),
             (dec, ok2)) in enumerate(steps):
        (k2, step, bits_step, X_s, R_s, x_s, Y_s, b0_s, b1_s, phi_s, A_s, B_s,
         alpha_s) = x
        stage2 = bool(junction)
        d = bits_step & race
        b = ec.select(d == 0, b0_s, b1_s)
        out[f"step{s_}.in_race"] = np.asarray(race)
        out[f"step{s_}.junction"] = np.asarray(junction)
        put(f"step{s_}.prev", prev)
        out[f"step{s_}.r"] = np.asarray(_stage_r(k2, stage2, n))
        out[f"step{s_}.new_race"] = np.asarray(new_race)
        out[f"step{s_}.new_junction"] = np.asarray(new_junction)
        put(f"step{s_}.new_prev", new_prev)
        out[f"step{s_}.deciding"] = np.asarray(dec)
        out[f"step{s_}.ok"] = np.asarray(ok2)
        if stage2:
            pts = dict(Xi=X_s, Ri=R_s, Yi=Y_s, Bj=prev.b, Xj=prev.X,
                       Rj=prev.R, Yj=prev.Y, Ci=phi_s, A=A_s, B=B_s)
            proof, _ = gen2(k2, pts, x_s, prev.x, alpha_s, d, prev.d, ids,
                            step, b)
        else:
            proof, _ = gen1(k2, X_s, Y_s, R_s, phi_s, A_s, B_s, x_s, alpha_s,
                            d, ids, step, b)
        put(f"step{s_}.proof", proof)
        out[f"step{s_}.b"] = np.asarray(b)

    # ---- full_step at step 0 (Stage1) and step 1 (Stage2) -------------------
    run_full = jax.jit(seal.full_step, static_argnums=(0, 10))
    for s_ in (0, 1):
        race, junction, prev = steps[s_][0]
        key = jax.random.key(SEED + 52 + s_)
        for name, v in zip(("xr", "v", "r"), _step_draws(key, bool(junction),
                                                         n)):
            out[f"full{s_}.draw.{name}"] = np.asarray(v)
        new_race, new_junction, new_prev, dec, ok = run_full(
            CURVE, key, jnp.asarray(s_, jnp.uint32), bits[:, s_], race,
            junction, prev, commit_pub, commit_sec, ids, True)
        out[f"full{s_}.new_race"] = np.asarray(new_race)
        out[f"full{s_}.new_junction"] = np.asarray(new_junction)
        put(f"full{s_}.new_prev", new_prev)
        out[f"full{s_}.deciding"] = np.asarray(dec)
        out[f"full{s_}.ok"] = np.asarray(ok)

    # ---- step_stage1, then step_stage2 against its outputs ------------------
    key = jax.random.key(SEED + 54)
    kc, k1, k2 = jax.random.split(key, 3)
    k_ab, k_v, k_wf = jax.random.split(kc, 3)
    bits1 = bits[:, 0]
    for name, v in (("ab", F.random(fn, k_ab, (2, n, 1))),
                    ("v", F.random(fn, k_v, (2, n, 1))),
                    ("r", F.random(fn, k_wf, (3, n, 1)))):
        out[f"stage1.commit_draw.{name}"] = np.asarray(v)
    k_xr, k_v1 = jax.random.split(k1)
    for name, v in (("xr", F.random(fn, k_xr, (2, n))),
                    ("v", F.random(fn, k_v1, (2, n))),
                    ("r", _stage_r(k2, False, n))):
        out[f"stage1.draw.{name}"] = np.asarray(v)
    race1 = jnp.ones((n,), jnp.uint32)
    dec1, ok1, new_race1, info1, cpub1, csec1 = jax.jit(
        seal.step_stage1, static_argnums=0)(CURVE, key, bits1, race1, ids)
    out["stage1.bits"] = np.asarray(bits1)
    out["stage1.deciding"], out["stage1.ok"] = np.asarray(dec1), np.asarray(ok1)
    out["stage1.new_race"] = np.asarray(new_race1)
    put("stage1.info", info1)
    put("stage1.commit_pub", cpub1)
    put("stage1.commit_sec", csec1)
    key = jax.random.key(SEED + 55)
    for name, v in zip(("xr", "v", "r"), _step_draws(key, True, n)):
        out[f"stage2.draw.{name}"] = np.asarray(v)
    bits2 = bits1         # the bit step_stage1's one-bit commitment holds
    dec2, ok2 = jax.jit(seal.step_stage2, static_argnums=0)(
        CURVE, key, bits2, new_race1, ids, info1, cpub1, csec1)
    out["stage2.bits"] = np.asarray(bits2)
    out["stage2.deciding"], out["stage2.ok"] = np.asarray(dec2), np.asarray(ok2)

    # ---- serialize_affine ---------------------------------------------------
    host = CURVE.host
    rng = random.Random(SEED + 56)
    pts = [host.mul(rng.randrange(1, host.n), host.g) for _ in range(3)] + [None]
    xs = [0 if q is None else q[0] for q in pts]
    ys = [0 if q is None else q[1] for q in pts]
    ax, ay = jnp.asarray(F.ints_to_limbs(xs)), jnp.asarray(F.ints_to_limbs(ys))
    inf = jnp.asarray([False, True, False, False])
    out["affine.x"], out["affine.y"] = np.asarray(ax), np.asarray(ay)
    out["affine.inf"] = np.asarray(inf)
    out["affine.bytes"] = np.asarray(ec.serialize_affine(ax, ay))
    out["affine.bytes_inf"] = np.asarray(ec.serialize_affine(ax, ay, inf))
    return out


P256_SEED = 0x9256


def p256_arrays():
    from privacy_auction_tpu.curves import get_curve

    curve = get_curve("p256")
    host = curve.host
    rng = random.Random(P256_SEED)
    out = {}
    for fname in ("fp", "fn"):
        spec = getattr(curve, fname)
        m = spec.modulus
        xs = [rng.randrange(m) for _ in range(8)] + [0, 1, m - 1, m - 2]
        ys = [rng.randrange(m) for _ in range(8)] + [m - 1, 0, m - 1, 2]
        a, b = jnp.asarray(F.ints_to_limbs(xs)), jnp.asarray(F.ints_to_limbs(ys))
        out[f"{fname}.a"], out[f"{fname}.b"] = np.asarray(a), np.asarray(b)
        for op in ("mul", "add", "sub"):
            out[f"{fname}.{op}"] = np.asarray(
                jax.jit(lambda a, b, op=op: getattr(F, op)(spec, a, b))(a, b))
        out[f"{fname}.inv"] = np.asarray(jax.jit(lambda a: F.inv(spec, a))(a))
        wide = [rng.randrange(1 << 512) for _ in range(6)] + [
            0, (1 << 512) - 1, m, m - 1, m * m - 1, (m - 1) ** 2]
        v = jnp.asarray(np.stack([F.int_to_limbs(x, 32) for x in wide]))
        out[f"{fname}.wide"] = np.asarray(v)
        out[f"{fname}.reduce_wide"] = np.asarray(
            jax.jit(lambda v: F.reduce_wide(spec, v))(v))
        w = np.asarray([[rng.randrange(1 << 32) for _ in range(16)]
                        for _ in range(6)], np.uint32)
        out[f"{fname}.rand_words"] = w
        out[f"{fname}.from_random_bits"] = np.asarray(
            jax.jit(lambda w: F.from_random_bits(spec, w))(jnp.asarray(w)))

    pts = [host.mul(rng.randrange(1, host.n), host.g) for _ in range(4)]
    case_p = [pts[0], pts[1], pts[0], None, pts[2], pts[2], None]
    case_q = [pts[1], pts[0], pts[0], pts[1], None, host.neg(pts[2]), None]
    P = jnp.asarray(ec.encode_host_points(case_p))
    Q = jnp.asarray(ec.encode_host_points(case_q))
    out["ec.add.P"], out["ec.add.Q"] = np.asarray(P), np.asarray(Q)
    out["ec.add"] = np.asarray(jax.jit(lambda P, Q: ec.add(curve, P, Q))(P, Q))
    out["ec.dbl"] = np.asarray(jax.jit(lambda P: ec.dbl(curve, P))(P))
    ks = [0, 1, host.n - 1] + [rng.randrange(host.n) for _ in range(2)]
    ts = [host.n - 1, 0, 1] + [rng.randrange(host.n) for _ in range(2)]
    k, t = jnp.asarray(F.ints_to_limbs(ks)), jnp.asarray(F.ints_to_limbs(ts))
    base = jnp.asarray(ec.encode_host_points([pts[3], pts[0], None, pts[1],
                                              pts[2]]))
    other = jnp.asarray(ec.encode_host_points([pts[2], None, pts[1], pts[3],
                                               pts[0]]))
    out["ec.k"], out["ec.t"] = np.asarray(k), np.asarray(t)
    out["ec.base"], out["ec.other"] = np.asarray(base), np.asarray(other)
    out["ec.scalar_mul"] = np.asarray(
        jax.jit(lambda P, k: ec.scalar_mul(curve, P, k))(base, k))
    out["ec.mul_base"] = np.asarray(jax.jit(lambda k: ec.mul_base(curve, k))(k))
    out["ec.dual_mul"] = np.asarray(jax.jit(
        lambda P, k, Q, t: ec.dual_mul(curve, P, k, Q, t))(base, k, other, t))
    out["ec.base_mul_add"] = np.asarray(jax.jit(
        lambda s, P, t: ec.base_mul_add(curve, s, P, t))(k, base, t))
    return out


CCS22_STEP_BIDS = (5, 3, 2, 6)   # bits 101, 011, 010, 110
CCS22_STEP_C = 3
# the transcript lengths of PoKDLog (with its step), PoWFCom, Stage1 and
# Stage2 (tag, generator, the points, id, step), CCS22's bidder (4c
# scalars) and evaluator (those and n*c betas) messages at 4x3, and the
# block boundaries
SHA256_LENGTHS = (218, 543, 1066, 1846, 4 * 3 * 32, 4 * 3 * 32 + 4 * 3 * 32,
                  0, 55, 56, 63, 64, 119)


def ccs22_step_arrays():
    out = {}

    def put(prefix, tup):
        for k, v in tup._asdict().items():
            out[f"{prefix}.{k}"] = np.asarray(v)

    bids, c = list(CCS22_STEP_BIDS), CCS22_STEP_C
    n = len(bids)
    bits = jnp.asarray(seal.bids_to_bits(bids, c))
    bid_scalars = jnp.asarray(F.ints_to_limbs(bids))
    key = jax.random.key(SEED + 60)
    draws = ccs22_draws(key, n, c)
    for k, v in draws.items():
        out[f"draw.{k}"] = np.asarray(v)
    out["bids"], out["c"] = np.asarray(bids), np.asarray(c)
    evals = (0, n - 1)
    out["evals"] = np.asarray(evals)
    pp = ccs22.make_pub_params(CURVE)
    keys = jax.random.split(key, 4)
    g1n = jnp.broadcast_to(jnp.asarray(pp.g1), (n, 3, ccs22.LIMBS))
    for eid in evals:
        eidt = jnp.asarray(eid, jnp.int32)
        pub, sec = ccs22._jit_setup(CURVE, keys[1], pp, bid_scalars, c, eidt,
                                    draws["beta"])
        pre = ccs22._precompute(CURVE, keys[2:4], pp, pub.X, sec,
                                draws["beta"])
        announced, r1, ots = ccs22._jit_scan_steps(CURVE, pre, g1n, bits, eidt)
        out[f"e{eid}.announced"] = np.asarray(announced)
        put(f"e{eid}.otr1", r1)
        put(f"e{eid}.ots", ots)
    # the streams do not depend on the evaluator (X = g^x)
    for name, v in zip(("enc0", "enc1", "T2", "M1", "gb", "hb", "z", "bz", "E",
                        "m0a"), pre):
        out[f"pre.{name}"] = np.asarray(v)
    return out


def sha256_arrays():
    from privacy_auction_tpu.ops import sha256 as S

    out = {"lengths": np.asarray(SHA256_LENGTHS)}
    rng = np.random.default_rng(SEED + 70)
    run = jax.jit(S.sha256)
    for length in SHA256_LENGTHS:
        msgs = rng.integers(0, 256, size=(3, length), dtype=np.uint8)
        out[f"msg{length}"] = msgs
        out[f"digest{length}_words"] = np.asarray(run(jnp.asarray(msgs)))
    return out


BUILDERS = {"seal": seal_arrays, "ccs22": ccs22_arrays,
            "ladders64": ladders64_arrays,
            "seal_metered": seal_metered_arrays,
            "ccs22_metered": ccs22_metered_arrays,
            "wire": wire_arrays, "p256": p256_arrays,
            "seal_step": seal_step_arrays, "ccs22_step": ccs22_step_arrays,
            "sha256": sha256_arrays}
# builders that share a file; the others write torch_golden_<name>.npz
SHARED_FILES = {"seal_metered": "metered", "ccs22_metered": "metered"}


def save(path: pathlib.Path, out: dict):
    packed = {}
    for k, val in out.items():
        val = np.asarray(val)
        if val.dtype == np.uint32 and not k.endswith("_words"):
            if int(val.max(initial=0)) >= (1 << 16):
                raise ValueError(f"{k}: not 16-bit limbs")
            val = val.astype(np.uint16)
        packed[k] = val
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **packed)
    print(f"wrote {path}: {len(packed)} arrays, {path.stat().st_size} bytes",
          flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="+", choices=sorted(BUILDERS),
                    default=sorted(BUILDERS))
    ap.add_argument("--out-dir", default=str(DATA))
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    files = {}
    for name in args.only:
        files.setdefault(SHARED_FILES.get(name, name), {}).update(
            BUILDERS[name]())
    for stem, out in files.items():
        path = pathlib.Path(args.out_dir) / f"torch_golden_{stem}.npz"
        if stem in SHARED_FILES.values() and path.exists():
            # keep the arrays of the sharing builders not run this time
            out = {**dict(np.load(path)), **out}
        save(path, out)


if __name__ == "__main__":
    main()
