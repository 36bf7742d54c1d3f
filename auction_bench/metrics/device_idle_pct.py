"""device_idle_pct: the share of the profiled auctions' wall in which no
operation ran on the device (the profiler's timeline)."""


def read(records: dict):
    p = records.get("profile")
    if not p or not p["window_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
