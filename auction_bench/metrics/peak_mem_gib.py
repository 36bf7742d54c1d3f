"""peak_mem_gib: `torch.cuda.max_memory_allocated()` over the window."""


def read(records: dict):
    if "peak_bytes" not in records:
        return None
    return records["peak_bytes"] / 2**30
