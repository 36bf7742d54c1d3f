"""setup_s: from the process's start to the end of the warm-up auction
(imports, CUDA context, the kernels' build or load, the protocol
driver's tables, one auction at the cell's shape)."""


def read(records: dict):
    return records["setup_s"]
