"""sha256.device_ms: the profiler's device time of `sha256_kernel`, per
profiled auction."""


def read(records: dict):
    p = records.get("profile")
    if not p or not p["sha256_kernel_count"]:
        return None
    return 1e3 * p["sha256_kernel_s"] / p["auctions"]
