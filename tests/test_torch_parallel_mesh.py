"""The port's bidder mesh in one process (`parallel/mesh.py`,
`parallel/distributed.py`), as tests/test_parallel.py checks the JAX
package's: padding, `init()` with no torchrun environment, the mesh of one
rank that `global_mesh()` falls back to, `process_info()`, and the
mesh's rows: shard and gather round trip, the flags, the broadcast, and a
rank's draws (`field.Rows`) equal to its rows of the unsharded draw."""

import pytest
import torch
import torch.distributed as dist

from privacy_auction_tpu_torch.curves import SECP256K1 as C
from privacy_auction_tpu_torch.ops import field as F
from privacy_auction_tpu_torch.parallel import distributed as D
from privacy_auction_tpu_torch.parallel import mesh as M


def test_one_rank_mesh_pads_shards_gathers_and_draws_rows(monkeypatch):
    assert M.pad_bidders(5, 8) == 8
    assert M.pad_bidders(8, 8) == 8
    assert M.pad_bidders(9, 8) == 16
    for name in D.ENV:
        monkeypatch.delenv(name, raising=False)
    assert not dist.is_initialized()
    assert D.init() is False and not dist.is_initialized()
    assert D.process_info() == {"process_index": 0, "process_count": 1,
                                "local_devices": 1, "global_devices": 1,
                                "platform": "cpu"}
    with pytest.raises(RuntimeError, match="no process group"):
        M.make_mesh()
    try:
        mesh = D.global_mesh()
        assert mesh.size() == 1 and mesh.mesh_dim_names == (M.BIDDER_AXIS,)
        assert D.init() is True          # the group runs: nothing to start
        info = D.process_info()
        assert info["process_count"] == 1 and info["process_index"] == 0
        assert info["global_devices"] >= info["local_devices"]
        with pytest.raises(ValueError, match="world size 1"):
            M.make_mesh(n_devices=2)
        assert M.bidder_rows(mesh, 6) == slice(0, 6)
        x = torch.arange(2 * 6 * 3).reshape(2, 6, 3)
        tree = (x, None, [x > 4])
        for m in (mesh, None):
            for dim in (0, 1):
                back = M.gather_bidders(m, M.shard_bidders(m, tree, dim), dim)
                assert torch.equal(back[0], x) and back[1] is None
                assert torch.equal(back[2][0], x > 4)
            assert M.all_true(m, torch.tensor([True, True]))
            assert not M.all_true(m, torch.tensor([[True, False]]))
            assert torch.equal(M.replicate(m, torch.tensor([7, 8])),
                               torch.tensor([7, 8]))
            assert 0 <= M.new_generator(m).initial_seed() < 2 ** 63
    finally:
        dist.destroy_process_group()
    # a rank's draws: the unsharded draw at every shape, its rows kept
    for dim, shape in ((1, (2, 6, 3)), (2, (2, 3, 6))):
        full = F.random(C.fn, torch.Generator().manual_seed(5), shape,
                        bidder_dim=dim)
        for rows in (slice(0, 2), slice(2, 4), slice(4, 6)):
            part = list(shape)
            part[dim] = 2
            got = F.random(C.fn, F.Rows(torch.Generator().manual_seed(5),
                                        rows, 6), part, bidder_dim=dim)
            assert torch.equal(got, full.narrow(dim, rows.start, 2))
    with pytest.raises(ValueError, match="bidder rows"):
        F.random(C.fn, F.Rows(torch.Generator(), slice(0, 2), 6), (2, 3, 3))
