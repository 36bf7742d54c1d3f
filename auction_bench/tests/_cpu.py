"""Cells of the benchmark cut to a size the CPU runs in seconds, for the
tests: the same harness, drivers and reference, on the port's plain path."""

import dataclasses

import torch

from auction_bench import run as R
from auction_bench import traffic as T

SIZES = {"seal-20x32": (2, 3), "ccs22-1024x64": (4, 4)}


def small_cell(workload: str) -> R.Cell:
    torch.set_num_threads(2)
    cell = R.Cell(workload)
    n, c = SIZES[workload]
    cell.mix = dataclasses.replace(cell.mix, n=n, c=c, check_lanes=2 * c)
    return cell


def race_matters(cell: R.Cell, seed: int) -> bool:
    """Whether the first window auction's outcome changes when the race
    never narrows (every bidder's bit counts at every step)."""
    bids = T.auction(cell.mix, seed, 0).bids
    c = cell.mix.c
    ored = [int(any((b >> (c - 1 - j)) & 1 for b in bids)) for j in range(c)]
    top = max(bids)
    return ored != [(top >> (c - 1 - j)) & 1 for j in range(c)]


def seed_where_race_matters(cell: R.Cell) -> int:
    return next(s for s in range(2**31, 2**31 + 1000) if race_matters(cell, s))
