"""The launch shape of the two group kernels that only the kernel validator
and the ladder bench reach (scalar_mul and the non-GLV base_mul_add, 64
windows, several threads a lane): the grid, block and dynamic shared memory
that `cuda_ec.launch_shape` gives for 1 ... 10,000 lanes.  Needs no card and
no JAX."""

from torch_launch_cases import TABLE, launch_serving_every_lane_once
from privacy_auction_tpu_torch.ops import cuda_ec


def test_ladders64_launch_shape_covers_every_lane_once():
    for kernel in ("scalar_mul", "base_mul_add"):
        # 8 threads a lane up to the threshold measured on the H100, then 4,
        # each a G that csrc/ec_ladders.cu builds
        assert kernel in cuda_ec.GROUP_KERNELS
        assert set(cuda_ec.GROUPS[kernel]) == {8, 4}
        for lanes in range(1, 10_001):
            group, _, threads, smem = launch_serving_every_lane_once(kernel, lanes)
            assert group == (8 if lanes <= 2048 else 4)
            # one warp of 32 // G lanes, a table of each lane, and for
            # base_mul_add the constant table of G once a block
            assert threads == 32
            const = 1 if kernel == "base_mul_add" else 0
            assert smem == (const + threads // group) * TABLE
    # the shared memory a block, at both G: 6 and 12 KiB for scalar_mul,
    # 7.5 and 13.5 KiB for base_mul_add
    assert [cuda_ec.launch_shape(k, 8192, group=g)[3]
            for k in ("scalar_mul", "base_mul_add") for g in (8, 4)] == [
                4 * TABLE, 8 * TABLE, 5 * TABLE, 9 * TABLE]
