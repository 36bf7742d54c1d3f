"""The metric readers: `<metric>.py` for each metric of `BENCHMARK.json`,
found by its name, each with `read(records) -> float | None`.  None: the
run has nothing to read for it, and the metric is left out of the result.

records: `setup_s`; `window_s`; `auctions`, one dict an auction of the
window (`wall_s`; `phase_s`, the protocol driver's `phase_times` in a
traced run, else None; `graphs`, the stats of the CUDA graphs it captured;
`profiled`); `peak_bytes` (`torch.cuda.max_memory_allocated()` over the
window); `sms` (the card's SMs); `profile` (a traced run's
`trace.summarize` of its profiled auctions, with `launches`, the EC and
SHA-256 launches by (row, lanes) the program counted in them, and
`auctions`, how many), else None."""
