"""Shared check of the group kernels' launch shape
(tests/test_torch_launch_shape*.py): the grid and block that
`cuda_ec.launch_shape` gives serve every lane once.  Needs no card and no
JAX."""

import numpy as np

from privacy_auction_tpu_torch.ops import cuda_ec

MAX_SMEM = 232_448    # dynamic shared memory a block may take on sm_90
TABLE = 16 * 96       # a window table: 16 entries of 96 B


def launch_serving_every_lane_once(kernel: str, lanes: int):
    """`cuda_ec.launch_shape(kernel, lanes)`, (group, blocks, threads,
    smem), after checking that each G built for the kernel can be asked
    for, that the block is whole warps within the shared memory an SM
    gives, and that its G threads serve each lane once, with only the last
    block ragged."""
    group, blocks, threads, smem = cuda_ec.launch_shape(kernel, lanes)
    for g in cuda_ec.GROUPS[kernel]:
        assert cuda_ec.launch_shape(kernel, lanes, group=g)[0] == g
    assert threads % 32 == 0             # whole warps: the shuffles
    assert smem <= MAX_SMEM
    # thread t of block b serves lane b * per_block + t // group
    per_block = threads // group
    lane = (np.arange(blocks)[:, None] * per_block
            + np.arange(threads)[None, :] // group)
    served = lane[lane < lanes]
    assert np.array_equal(np.bincount(served, minlength=lanes),
                          np.full(lanes, group))
    assert (lane >= lanes).sum() < threads   # only the last block is ragged
    return group, blocks, threads, smem
