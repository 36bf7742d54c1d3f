"""Helpers the metric readers share: which auctions of a run a counter
metric reads."""


def unprofiled(records: dict) -> list[dict]:
    """The window's auctions the profiler did not slow down (all, if it
    slowed every one)."""
    plain = [a for a in records["auctions"] if not a["profiled"]]
    return plain or records["auctions"]
