"""The SHA-256 kernel's split into producer warps and a consumer warp, on
the host: its device functions compiled by g++ (tests/torch_sha256_host.py)
against the JAX package's digests, and its ring's work split.

The ring's index arithmetic is checked at the lane counts at a consumer
warp's edges and the paths' largest (1, 20, 31, 32, 33, 64 and 2,053) and
at 1, 17 and 385 blocks a message: each CTA's producer makes every (lane,
block) pair exactly once, into the slot and column the consumer reads it
from, and the slots pass between the warps as the kernel's barriers pass
them, with no slot written again before the consumer gave it back and no
wait that never ends.  Compiles no JAX: the digests are the golden file's.
"""

import ctypes
import pathlib

import numpy as np

from torch_sha256_host import host_library

GOLDEN = pathlib.Path(__file__).resolve().parent / "data" / "torch_golden_sha256.npz"
WARP = 32
LANES = (1, 20, 31, 32, 33, 64, 2053)
BLOCKS = (1, 17, 385)


def _golden_digests(dll):
    gold = np.load(GOLDEN)
    for length in gold["lengths"]:
        msgs = gold[f"msg{length}"]
        want = gold[f"digest{length}_words"].astype(np.int64)
        for aligned in (0, 1):
            if aligned and length % 4:
                continue
            buf = np.zeros(msgs.size + 8, dtype=np.uint8)
            off = 0 if aligned else 1
            buf[off:off + msgs.size] = msgs.reshape(-1)
            out = np.zeros_like(want)
            dll.run(buf.ctypes.data + off, out.ctypes.data, msgs.shape[0],
                    int(length), aligned)
            np.testing.assert_array_equal(
                out, want, err_msg=f"{length} B, aligned={aligned}")


def _split(dll, L, blocks):
    """One CTA of L lanes: who makes each pair, and the slot passing."""
    slots = dll.slots()
    fills = dll.ring_fills(blocks, L)
    made = {}
    lane, block = ctypes.c_int(), ctypes.c_longlong()
    for f in range(fills):
        for p in range(WARP):
            if dll.ring_pair(p, L, f, blocks, ctypes.byref(lane),
                             ctypes.byref(block)):
                key = (lane.value, block.value)
                assert key not in made, f"L={L}: {key} made twice"
                made[key] = (f, dll.ring_slot(f), p)
    want = {(l, b) for l in range(L) for b in range(blocks)}
    assert set(made) == want, f"L={L}, {blocks} blocks: pairs made"
    for (l, b), (f, slot, col) in made.items():
        assert (dll.block_fill(b, L), dll.block_column(l, L, b)) == (f, col), (
            f"L={L}: lane {l} block {b} read from another place")
        assert 0 <= col < WARP and 0 <= slot < slots

    # the barriers' protocol, step by step: producer warp w writes its
    # fills w, w + P, ... (P warps) in order, fill f into its slot after
    # fill_reused(f) was given back; the consumer waits for
    # fill_awaited(b) before it reads block b (the kernel waits for the
    # next block's fill while it runs the last eight rounds of this one, so
    # before it gives back this one's), then gives back fill_released(b)
    producers = dll.producers()
    by_fill = {}
    for key, (f, slot, col) in made.items():
        by_fill.setdefault(f, []).append((slot, col, key))
    reused = [dll.fill_reused(f) for f in range(fills)]
    for f, r in enumerate(reused):
        # a slot is always one producer warp's: its barriers pair that
        # warp with the consumer
        if r >= 0:
            assert (dll.ring_slot(r), r % producers) == (
                dll.ring_slot(f), f % producers), f"fill {f} reuses {r}"
    for order in ("producers first", "consumer first"):
        ring = {}
        full, released = set(), set()
        next_fill = list(range(producers))
        b, pending = 0, dll.fill_awaited(0, L)

        def produce(w):
            f = next_fill[w]
            if f >= fills or (reused[f] >= 0 and reused[f] not in released):
                return False
            for slot, col, key in by_fill.get(f, ()):
                ring[(slot, col)] = key
            full.add(f)
            next_fill[w] += producers
            return True

        def consume():
            nonlocal b, pending
            if b >= blocks or (pending >= 0 and pending not in full):
                return False
            nxt = dll.fill_awaited(b + 1, L) if b + 1 < blocks else -1
            if nxt >= 0 and nxt not in full:
                return False
            f = dll.block_fill(b, L)
            for l in range(L):
                place = (dll.ring_slot(f), dll.block_column(l, L, b))
                assert ring.get(place) == (l, b), (
                    f"L={L}, {blocks} blocks ({order}): lane {l} block {b} "
                    f"finds {ring.get(place)}")
            rel = dll.fill_released(b, L, blocks)
            if rel >= 0:
                assert rel == f and rel not in released
                released.add(rel)
            b, pending = b + 1, nxt
            return True

        warps = [lambda w=w: produce(w) for w in range(producers)]
        steps = warps + [consume] if order == "producers first" else [consume] + warps
        while any(step() for step in steps):
            pass
        assert min(next_fill) >= fills and b == blocks, (
            f"L={L}, {blocks} blocks ({order}): stopped at fills {next_fill}, "
            f"block {b}")
        # every slot given back is waited for, and no other
        assert released == {r for r in reused if r >= 0}


def test_split_matches_golden_and_its_ring_is_sound(tmp_path):
    dll = host_library(tmp_path)
    _golden_digests(dll)
    seen = set()
    for lanes in LANES:
        ctas = -(-lanes // WARP)
        ls = [dll.cta_lanes(lanes, c) for c in range(ctas)]
        assert sum(ls) == lanes and all(1 <= x <= WARP for x in ls)
        assert ls[:-1] == [WARP] * (ctas - 1)
        for L in set(ls):
            for blocks in BLOCKS:
                if (L, blocks) not in seen:
                    seen.add((L, blocks))
                    _split(dll, L, blocks)
