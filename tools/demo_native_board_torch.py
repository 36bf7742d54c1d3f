"""Multi-process SEAL AV-net auction over the native bulletin-board hub, on
the host.

    python tools/demo_native_board_torch.py [n] [c] [seed]

The port's counterpart of tools/demo_native_board.py.  Each bidder is an
OS process: it connects to the C++ board hub (`native/pa_runtime.cc`,
through `privacy_auction_tpu_torch/runtime/native.py`) over a Unix-domain
socket, publishes its per-step AV-net key X = g^x and veto ciphertext b,
fetches every party's messages (a blocking fetch is the barrier of the
reference's phase loops, `SEAL/main.cpp:65-120`) and accumulates the max
bid itself.  The parties' arithmetic is the pure-int host oracle
(`privacy_auction_tpu_torch/utils/host_curve.py`): this exercises the hub,
not the kernels, and launches none.  NIZKs are left out, as the
reference's ENABLE_VERIFICATION=off mode (`SEAL/params.h:13`); the verified
multi-process auction on the card is `runtime/party.py`.  The hub runs in
a process of its own that the demo kills at the end (`party.serve_hub`).

Exit code 0 iff every party's max bid equals the plaintext maximum; the
hub's byte meters are printed.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pathlib
import random
import shutil
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

PHASE_ROUND1 = 1
PHASE_ROUND2 = 2
PHASE_RESULT = 7
TIMEOUT_S = 120.0


def _ser(P) -> bytes:
    """SEC1 uncompressed; infinity = 65 zero bytes (one message size)."""
    if P is None:
        return bytes(65)
    x, y = P
    return b"\x04" + x.to_bytes(32, "big") + y.to_bytes(32, "big")


def _deser(b: bytes):
    if b[0] == 0:
        return None
    return (int.from_bytes(b[1:33], "big"), int.from_bytes(b[33:65], "big"))


def run_party(sock_path: str, pid: int, n: int, c: int, bid: int,
              seed: int) -> None:
    """One bidder process: the reference's per-party loop body
    (`SEAL/main.cpp:46-120`) against the remote board."""
    from privacy_auction_tpu_torch.runtime.native import BoardClient
    from privacy_auction_tpu_torch.utils.host_curve import SECP256K1 as HOST

    rng = random.Random(seed)
    cl = BoardClient(sock_path, connect_timeout_s=60.0)
    bits = [(bid >> (c - 1 - i)) & 1 for i in range(c)]
    in_race = True
    max_bid = 0
    for step in range(c):
        d = bits[step] if in_race else 0
        # round 1: publish X = g^x (`SEAL/bidder.cpp:1203-1236`)
        x = rng.randrange(1, HOST.n)
        r = rng.randrange(1, HOST.n)
        cl.post(PHASE_ROUND1, step, pid, _ser(HOST.mul(x, HOST.g)))
        Xs = [_deser(cl.fetch_wait(PHASE_ROUND1, step, j, timeout_s=TIMEOUT_S))
              for j in range(n)]
        # Y_pid = sum_{j<pid} X_j - sum_{j>pid} X_j (`SEAL/bidder.cpp:1286-1299`)
        Y = None
        for j in range(pid):
            Y = HOST.add(Y, Xs[j])
        for j in range(pid + 1, n):
            Y = HOST.add(Y, HOST.neg(Xs[j]))
        # round 2: b = x*Y (d = 0) | a random point (d = 1)
        # (`SEAL/bidder.cpp:1301-1309`)
        b = HOST.mul(x, Y) if d == 0 else HOST.mul(r, HOST.g)
        cl.post(PHASE_ROUND2, step, pid, _ser(b))
        total = None
        for j in range(n):
            total = HOST.add(total, _deser(
                cl.fetch_wait(PHASE_ROUND2, step, j, timeout_s=TIMEOUT_S)))
        # round 3: the step decides iff the veto sum is not infinity
        # (`SEAL/bidder.cpp:1386-1411`)
        if total is not None:
            max_bid = (max_bid << 1) | 1
            in_race = in_race and d == 1
        else:
            max_bid <<= 1
    cl.post(PHASE_RESULT, 0, pid, max_bid.to_bytes(8, "big"), "result")
    cl.close()


def main(n: int = 4, c: int = 4, seed: int = 0) -> int:
    from privacy_auction_tpu_torch.runtime import native, party
    from privacy_auction_tpu_torch.runtime.native import BoardClient

    native.load()                       # make -C native once, before the spawns
    rng = random.Random(seed)
    bids = [rng.randrange(1 << c) for _ in range(n)]
    tmp = tempfile.mkdtemp(prefix="pa_board_")
    sock = os.path.join(tmp, "board.sock")
    ctx = mp.get_context("spawn")
    hub = ctx.Process(target=party.serve_hub, args=(sock, n), daemon=True)
    procs = [ctx.Process(target=run_party,
                         args=(sock, i, n, c, bids[i], seed + 1 + i))
             for i in range(n)]
    cl = None
    try:
        hub.start()
        cl = BoardClient(sock, connect_timeout_s=60.0)
        for p in procs:
            p.start()
        results = [int.from_bytes(cl.fetch_wait(PHASE_RESULT, 0, i, "result",
                                                TIMEOUT_S), "big")
                   for i in range(n)]
        for p in procs:
            p.join(timeout=30)
        meters = {k: cl.bytes(k) for k in ("bidder", "result")}
        total = cl.total_bytes()
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if cl is not None:
            cl.close()
        if hub.pid is not None:
            hub.kill()
            hub.join()
        shutil.rmtree(tmp, ignore_errors=True)
    ok = all(r == max(bids) for r in results) and all(
        p.exitcode == 0 for p in procs)
    print(f"[demo] n={n} c={c} bids={bids} -> agreed maxBid="
          f"{results[0] if ok else results}")
    print(f"[demo] hub meters: bidder={meters['bidder']} B, "
          f"result={meters['result']} B, total={total} B")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(*(int(a) for a in sys.argv[1:4])))
