"""graph_kernel_nodes: the kernel nodes of the step graphs an auction
captures, summed over its graphs (an exact count; the mean over the
window's auctions)."""


def read(records: dict):
    runs = [a["graphs"] for a in records["auctions"] if a["graphs"]]
    if not runs:
        return None
    return sum(sum(g["kernels"] for g in gs) for gs in runs) / len(runs)
