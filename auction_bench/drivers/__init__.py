"""One adapter a protocol, found by a configuration's `protocol`: how the
window calls the program's driver and what of its result the check reads.

Each module gives `prepare(config, mix, device)` (the program's curve and
what set-up loads), `run(state, auction, phase_times)` (the timed call),
`keep(result, auction, lanes)` (what the check will read, taken
after the call without waiting for the device), `graphs(state)` (the
stats of the CUDA graphs the last call captured), `to_host(kept)` and
`check(host, auction, lanes, bases, mix)` (the plain reference's
verdict)."""
