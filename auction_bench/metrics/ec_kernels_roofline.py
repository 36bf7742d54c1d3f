"""ec_kernels_roofline: the EC kernels' share of their roofline over the
profiled auctions: the least time of every EC launch they made (the
benchmark's frozen count, `yardstick.launch_bound_s`, at each launch's
lanes; the program's launch counters, a graph's warm-up step included),
over the profiler's device time of those kernels."""

from auction_bench import yardstick


def read(records: dict):
    p = records.get("profile")
    if not p or not p["ec_kernel_s"]:
        return None
    bound = sum(v * yardstick.launch_bound_s(row, lanes, records["sms"])
                for (row, lanes), v in p["launches"].items()
                if row in yardstick.LANE_OPS)
    return 100.0 * bound / p["ec_kernel_s"]
