"""The benchmark's frozen work counts and peaks: what an EC kernel launch
needs at the least, so that a roofline share does not move when the
program changes its own counts.

Copied from the program as it stood when the benchmark was written
(`ops/cuda_ec.py` `int_muls` and its `MULS_*` constants, `chip_smoke.py`'s
bytes a lane and multiply rate); the program's copies may change, these
may not.

A launch's bound is the larger of its 32-bit integer multiplies over the
card's multiply rate and its bytes over HBM bandwidth.  Multiplies: a
wide 32x32 -> 64 product is two 32-bit multiply results (low and high
word); a field mul is 64 schoolbook products plus 9 in the fold by
2^32 + 977; a squaring 36 (+ 9); a mul by a small odd constant (3, 21,
63) 8 (+ 1); a mul by 2 or 8 is a shift, only its fold multiplies (1).
Point add: RCB16 Alg 7 (12 muls, 3 small); double: Alg 9 (6 muls, 2
squarings, 2 small, 2 shifts).  A Straus ladder of w 4-bit windows over S
sources: 14 adds a source to build its 16-entry table, then a window: 4
doublings and one add a source (the comb: one add a window, 64 windows;
base_mul_add's generator table and base_mul_add_glv's two constant tables
are built on the host).  Bytes: each input read once and the output
written once, int64 limbs (a point 384 B, a scalar 128 B, sign flags
16 B), and the constant tables once a launch.
"""

from __future__ import annotations

MULS_FE_MUL = 2 * (64 + 9)
MULS_FE_SQR = 2 * (36 + 9)
MULS_FE_SMALL = 2 * (8 + 1)
MULS_FE_SHIFT = 2 * 1
MULS_PT_ADD = 12 * MULS_FE_MUL + 3 * MULS_FE_SMALL
MULS_PT_DBL = (6 * MULS_FE_MUL + 2 * MULS_FE_SQR + 2 * MULS_FE_SMALL
               + 2 * MULS_FE_SHIFT)

COMB_WINDOWS = 64
GLV_WINDOWS = 33
# (adds, doublings) of one lane, by the program's launch row
# (`cuda_ec.launch_lanes` keys): the secp256k1 paths launch the GLV forms
# at 33 windows, the full-scalar forms at 64
LANE_OPS = {
    "mul_comb": (COMB_WINDOWS, 0),
    "pt_add": (1, 0),
    "scalar_mul": (14 + COMB_WINDOWS, 4 * COMB_WINDOWS),
    "base_mul_add": (14 + 2 * COMB_WINDOWS, 4 * COMB_WINDOWS),
    "dual_mul": (2 * 14 + 2 * GLV_WINDOWS, 4 * GLV_WINDOWS),
    "dual_mul_64": (2 * 14 + 2 * COMB_WINDOWS, 4 * COMB_WINDOWS),
    "quad_mul": (4 * 14 + 4 * GLV_WINDOWS, 4 * GLV_WINDOWS),
    "base_mul_add_glv": (2 * 14 + 4 * GLV_WINDOWS, 4 * GLV_WINDOWS),
}
POINT, SCALAR = 384, 128
LANE_BYTES = {
    "mul_comb": SCALAR + POINT,
    "pt_add": 3 * POINT,
    "scalar_mul": POINT + SCALAR + POINT,
    "base_mul_add": POINT + 2 * SCALAR + POINT,
    "dual_mul": 2 * (POINT + SCALAR) + POINT,
    "dual_mul_64": 2 * (POINT + SCALAR) + POINT,
    "quad_mul": 4 * (POINT + SCALAR) + POINT,
    "base_mul_add_glv": 2 * (POINT + SCALAR) + 2 * SCALAR + 16 + POINT,
}
TABLE_BYTES = {"mul_comb": 64 * 16 * POINT, "base_mul_add": 16 * POINT,
               "base_mul_add_glv": 2 * 16 * POINT}

# An H100 SXM: 64 32-bit integer multiply results a clock an SM at compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput), at the 1.98 GHz boost clock behind the published peaks;
# HBM3 at 3.35 TB/s (NVIDIA's data sheet).
INT_MULS_PER_CLOCK_SM = 64
BOOST_CLOCK_HZ = 1.98e9
HBM_BYTES_S = 3.35e12


def int_muls(row: str, lanes: int) -> int:
    adds, dbls = LANE_OPS[row]
    return lanes * (adds * MULS_PT_ADD + dbls * MULS_PT_DBL)


def launch_bound_s(row: str, lanes: int, sms: int) -> float:
    """The least time one launch of `row` over `lanes` lanes takes on a
    card of `sms` SMs."""
    rate = INT_MULS_PER_CLOCK_SM * sms * BOOST_CLOCK_HZ
    return max(int_muls(row, lanes) / rate,
               (lanes * LANE_BYTES[row] + TABLE_BYTES.get(row, 0))
               / HBM_BYTES_S)
