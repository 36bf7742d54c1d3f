"""The Python side of the group kernels' launch (mul_comb, dual_mul,
quad_mul and base_mul_add_glv, several threads a lane): the grid, block and
dynamic shared memory that `cuda_ec.launch_shape` gives for 1 ... 10,000
lanes, and the packing of the constant tables to 32-bit words.  Needs no
card and no JAX."""

import torch

from torch_launch_cases import MAX_SMEM, TABLE, launch_serving_every_lane_once
from privacy_auction_tpu_torch.curves import SECP256K1 as C
from privacy_auction_tpu_torch.ops import cuda_ec
from privacy_auction_tpu_torch.ops import field as F

# the group kernels of the auctions' path; scalar_mul and base_mul_add are
# tests/test_torch_launch_shape_ladders64.py
KERNELS = ("mul_comb", "dual_mul", "quad_mul", "base_mul_add_glv")


def _unpack(words: torch.Tensor) -> torch.Tensor:
    w = words.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & 0xFFFF, w >> 16], dim=-1).flatten(-2)


def test_group_launch_shape_covers_every_lane_once_and_packing_round_trips():
    for kernel in KERNELS:
        # 8 threads a lane for the small, latency-bound launches, fewer for
        # the larger ones (the thresholds measured on the H100), each a G
        # that csrc/ec_ladders.cu builds
        comb = kernel == "mul_comb"
        assert set(cuda_ec.GROUPS[kernel]) == ({8, 2} if comb else {8, 4})
        for lanes in range(1, 10_001):
            group, blocks, threads, smem = launch_serving_every_lane_once(kernel, lanes)
            if lanes <= (4096 if comb else 2048):
                assert group == 8
            else:
                assert group == (2 if comb else 4)
            per_block = threads // group
            if kernel == "mul_comb":
                # 4 ... 12 warps, the fewest that put at most one block on
                # each SM; a ring of 2 ... 64 window tables of the comb,
                # shared by the block's lanes
                warps = threads // 32
                assert 4 <= warps <= 12
                assert blocks <= cuda_ec.SMS or warps == 12
                assert warps == 4 or -(-lanes // ((warps - 1) * 32 // group)) > cuda_ec.SMS
                assert smem == cuda_ec.COMB_RING * TABLE and 2 <= cuda_ec.COMB_RING <= 64
            else:
                # one warp; dual_mul and quad_mul: the two or four tables of
                # each lane; the GLV kernel: the two constant tables once, and
                # the two per-lane tables of each lane
                assert threads == 32
                tables = {"dual_mul": 2 * per_block, "quad_mul": 4 * per_block,
                          "base_mul_add_glv": 2 + 2 * per_block}[kernel]
                assert smem == tables * TABLE
    # mul_comb's block shapes beside the default: the whole comb table fits
    assert cuda_ec.comb_shape(100, 8, warps=8, ring=64) == (8, 4, 256, 64 * TABLE)
    assert cuda_ec.comb_shape(300, 2, warps=2, ring=3) == (2, 10, 64, 3 * TABLE)
    # the auctions' largest launches: one block an SM, or 12 warps
    assert cuda_ec.comb_shape(16384, 2) == (2, 128, 256, 2 * TABLE)
    assert cuda_ec.comb_shape(20480, 2) == (2, 128, 320, 2 * TABLE)
    assert cuda_ec.comb_shape(100_000, 2)[1:3] == (521, 384)
    assert 64 * TABLE <= MAX_SMEM

    # the constant tables, packed once per tensor and kept while unchanged
    for name in ("g0_tables", "comb_table"):
        limbs = C.tensor(name, "cpu")
        words = cuda_ec.packed_words(limbs)
        assert words.dtype == torch.int32 and words.shape[-1] == F.LIMBS // 2
        assert torch.equal(_unpack(words), limbs)
        assert cuda_ec.packed_words(limbs) is words
    t = C.tensor("g0_tables", "cpu").clone()
    first = cuda_ec.packed_words(t)
    t[0, 1, 0, 0] ^= 1
    again = cuda_ec.packed_words(t)
    assert again is not first and torch.equal(_unpack(again), t)
