"""The Python side of the group kernels' launch (quad_mul and
base_mul_add_glv, several threads a lane): the grid, block and dynamic shared
memory that `cuda_ec.launch_shape` gives for 1 ... 10,000 lanes, and the
packing of the constant tables to 32-bit words.  Needs no card and no JAX."""

import numpy as np
import torch

from privacy_auction_tpu_torch.curves import SECP256K1 as C
from privacy_auction_tpu_torch.ops import cuda_ec
from privacy_auction_tpu_torch.ops import field as F

MAX_SMEM = 232_448    # dynamic shared memory a block may take on sm_90


def _unpack(words: torch.Tensor) -> torch.Tensor:
    w = words.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & 0xFFFF, w >> 16], dim=-1).flatten(-2)


def test_group_launch_shape_covers_every_lane_once_and_packing_round_trips():
    table = 16 * 96
    for kernel in ("quad_mul", "base_mul_add_glv"):
        for lanes in range(1, 10_001):
            group, blocks, threads, smem = cuda_ec.launch_shape(kernel, lanes)
            # 8 threads a lane for the small, latency-bound launches
            assert group == (8 if lanes <= cuda_ec.GROUP8_MAX_LANES else 4)
            assert threads == 32                 # one whole warp: the shuffles
            per_block = threads // group
            # quad_mul: the four tables of each lane; the GLV kernel: the two
            # constant tables once, and the two per-lane tables of each lane
            tables = 4 * per_block if kernel == "quad_mul" else 2 + 2 * per_block
            assert smem == tables * table <= MAX_SMEM
            # thread t of block b serves lane b * per_block + t // group
            lane = (np.arange(blocks)[:, None] * per_block
                    + np.arange(threads)[None, :] // group)
            served = lane[lane < lanes]
            assert np.array_equal(np.bincount(served, minlength=lanes),
                                  np.full(lanes, group))
            assert (lane >= lanes).sum() < threads   # only the last block is ragged

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
