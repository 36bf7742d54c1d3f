"""The one traffic generator: a mix's parameters (a `traffic/<name>.json`)
and a seed give every auction of a run.

Auction i of a run is drawn from (seed, WINDOW, i): its n bids, uniform in
[0, 2^c); the seed of its nonce generator (a CPU `torch.Generator`, which
the program draws every nonce from); its evaluator lane, uniform in
[0, n) (CCS22 reads it, SEAL does not); and the seed of the lanes the
check samples.  The warm-up auction is drawn from (seed, WARMUP, 0), apart
from the window's.  Every seed gives every auction the same sizes, so the
work of a run does not depend on its seed; only the values do.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

WINDOW, WARMUP = 1, 2
KEYS = {"n", "c", "bids", "loop", "clients", "check_lanes", "profile_auctions",
        "why"}


@dataclass(frozen=True)
class Mix:
    """A traffic mix: n bidders of c-bit bids, `clients` closed loops (one
    auction outstanding each), `check_lanes` (bidder, step) lanes of each
    auction's board judged by the reference, and `profile_auctions`
    auctions of a traced run under the profiler."""

    name: str
    n: int
    c: int
    bids: str
    loop: str
    clients: int
    check_lanes: int
    profile_auctions: int

    @classmethod
    def from_dict(cls, name: str, d: dict) -> "Mix":
        unknown = set(d) - KEYS
        if unknown:
            raise ValueError(f"traffic {name}: unknown keys {sorted(unknown)}")
        mix = cls(name=name, **{k: d[k] for k in KEYS - {"why"}})
        if mix.bids != "uniform" or mix.loop != "closed" or mix.clients != 1:
            raise ValueError(f"traffic {name}: the generator makes uniform bids "
                             "for one closed-loop client")
        if not (1 <= mix.c <= 64 and mix.n >= 2 and mix.check_lanes >= 1
                and mix.profile_auctions >= 1):
            raise ValueError(f"traffic {name}: sizes out of range")
        return mix


@dataclass(frozen=True)
class Auction:
    index: int
    bids: tuple[int, ...]
    nonce_seed: int
    eval_id: int
    check_seed: int


def auction(mix: Mix, seed: int, index: int, stream: int = WINDOW) -> Auction:
    """Auction `index` of `stream` (WINDOW or WARMUP) for `seed`."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, stream, index]))
    bids = rng.integers(0, (1 << mix.c) - 1, size=mix.n, endpoint=True,
                        dtype=np.uint64)
    nonce_seed, check_seed = (int(v) for v in rng.integers(0, 1 << 62, size=2))
    return Auction(index=index, bids=tuple(int(b) for b in bids),
                   nonce_seed=nonce_seed, eval_id=int(rng.integers(0, mix.n)),
                   check_seed=check_seed)


def sample_lanes(mix: Mix, a: Auction) -> list[tuple[int, int]]:
    """The (bidder, step) lanes the check judges in auction `a`:
    `check_lanes` of them, spread over the steps (each step once before
    any twice), the bidder of each uniform."""
    rng = np.random.default_rng(np.random.SeedSequence([a.check_seed]))
    steps = []
    while len(steps) < mix.check_lanes:
        steps += [int(s) for s in rng.permutation(mix.c)]
    steps = steps[:mix.check_lanes]
    bidders = rng.integers(0, mix.n, size=len(steps))
    return sorted({(int(i), j) for i, j in zip(bidders, steps)})
