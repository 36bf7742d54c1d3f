"""The port's copy of the native runtime binding
(`privacy_auction_tpu_torch/runtime/native.py`): posts, fetches and byte
meters of a board in this process and of one served over its Unix socket
to a client, as tests/test_native_runtime.py holds the JAX package's copy.
Skipped, as that file is, when the library is not built and cannot be."""

import pytest
import torch

from privacy_auction_tpu_torch.runtime import native

torch.set_num_threads(1)


def test_board_and_served_board_round_trip(tmp_path):
    if not native.available():
        pytest.skip("native runtime not built and no toolchain")
    b = native.NativeBoard(4)
    payload = bytes(range(256))
    b.post(native.PHASE_ROUND1, 0, 2, payload, "bidder")
    assert b.fetch(native.PHASE_ROUND1, 0, 2, "verifier") == payload
    assert b.fetch(native.PHASE_ROUND1, 0, 3) is None      # absent: unmetered
    assert b.n_parties == 4
    b.account("evaluator", 50)
    assert (b.bytes("bidder"), b.bytes("verifier"), b.bytes("evaluator")) == \
        (256, 256, 50)
    assert b.total_bytes() == 562
    b.reset()
    assert b.total_bytes() == 0

    board = native.NativeBoard(2)
    server = board.serve(str(tmp_path / "board.sock"))
    try:
        cl = native.BoardClient(server.sock_path)
        assert cl.fetch(native.PHASE_COMMIT, 0, 1) is None
        cl.post(native.PHASE_COMMIT, 0, 1, b"z" * 100, "bidder")
        for _ in range(3):       # the reused receive buffer, fetched again
            assert cl.fetch_wait(native.PHASE_COMMIT, 0, 1, "verifier",
                                 timeout_s=10.0) == b"z" * 100
        with pytest.raises(TimeoutError):
            cl.fetch_wait(native.PHASE_COMMIT, 0, 0, timeout_s=0.05)
        assert (board.bytes("bidder"), board.bytes("verifier")) == (100, 300)
        assert cl.total_bytes() == board.total_bytes() == 400
        cl.reset()
        assert board.total_bytes() == 0
        cl.close()
    finally:
        server.stop()
