"""The frozen work count of one launch of each EC kernel, against a count
made by hand: a field mul 2 x (64 + 9) = 146 multiplies, a squaring
2 x (36 + 9) = 90, a small-constant mul 2 x (8 + 1) = 18, a shift's fold
2; a point add 12 x 146 + 3 x 18 = 1,806, a doubling 6 x 146 + 2 x 90 +
2 x 18 + 2 x 2 = 1,096."""

import pytest

from auction_bench import yardstick as Y

ADD, DBL = 1806, 1096
HAND = {
    "mul_comb": 64 * ADD,                            # 115,584
    "pt_add": ADD,
    "scalar_mul": (14 + 64) * ADD + 256 * DBL,       # 421,444
    "base_mul_add": (14 + 128) * ADD + 256 * DBL,    # 537,028
    "dual_mul": (28 + 66) * ADD + 132 * DBL,         # 314,436
    "dual_mul_64": (28 + 128) * ADD + 256 * DBL,     # 562,312
    "quad_mul": (56 + 132) * ADD + 132 * DBL,        # 484,200
    "base_mul_add_glv": (28 + 132) * ADD + 132 * DBL,  # 433,632
}


def test_point_formulas():
    assert Y.MULS_PT_ADD == ADD and Y.MULS_PT_DBL == DBL


@pytest.mark.parametrize("row", sorted(HAND))
def test_one_lane(row):
    assert Y.int_muls(row, 1) == HAND[row]
    assert Y.int_muls(row, 640) == 640 * HAND[row]


def test_hand_numbers():
    assert HAND["scalar_mul"] == 421_444 and HAND["quad_mul"] == 484_200
    assert HAND["base_mul_add_glv"] == 433_632 and HAND["dual_mul"] == 314_436


def test_every_row_has_a_count_and_bytes():
    assert set(Y.LANE_OPS) == set(Y.LANE_BYTES) == set(HAND)


@pytest.mark.parametrize("row", sorted(HAND))
def test_bound_is_the_larger_of_multiplies_and_bytes(row):
    sms, lanes = 132, 4096
    rate = 64 * sms * 1.98e9
    ops = HAND[row] * lanes / rate
    mem = (lanes * Y.LANE_BYTES[row] + Y.TABLE_BYTES.get(row, 0)) / 3.35e12
    assert Y.launch_bound_s(row, lanes, sms) == pytest.approx(max(ops, mem))
    # pt_add moves bytes; the ladders multiply
    assert (mem > ops) == (row == "pt_add")
