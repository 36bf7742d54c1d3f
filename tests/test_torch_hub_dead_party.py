"""A party process of the port's hub auction that dies (SIGKILL) makes
`run_hub_auction` stop the others and raise with its exit code within
seconds, not after its 600 s wait for results, and leaves no child (party
or hub) running."""

import multiprocessing as mp
import os
import signal
import threading
import time

import pytest
import torch

from privacy_auction_tpu_torch.runtime import native
from privacy_auction_tpu_torch.runtime.party import run_hub_auction

torch.set_num_threads(1)


def test_dead_party_stops_the_auction():
    if not native.available():
        pytest.skip("native runtime not built and no toolchain")
    killed = []

    def kill_one():
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not killed:
            # the parties (the hub is the one daemonic child)
            kids = [p for p in mp.active_children() if not p.daemon]
            if len(kids) == 3:
                time.sleep(2.0)      # while they start up or commit
                victim = min(kids, key=lambda p: p.pid)
                os.kill(victim.pid, signal.SIGKILL)
                killed.append(victim.pid)
            time.sleep(0.05)

    t0 = time.monotonic()
    killer = threading.Thread(target=kill_one)
    killer.start()
    try:
        with pytest.raises(RuntimeError, match=r"exited with code -9"):
            run_hub_auction(3, 2, [0, 0, 3], seed=11, timeout_s=600.0,
                            device="cpu")
    finally:
        killer.join()
    assert killed
    assert time.monotonic() - t0 < 60
    assert mp.active_children() == []
