"""tools/bench_seal_parts_torch.py at 3x2 on the CPU: the fused SEAL
driver's runs verify and find the maximum (exit 0), and each phase of
`run_auction(phase_times=...)` is printed, the checks only with
verification."""

import re

import torch_tool_cases as T

PHASES = ("commit", "round_one", "avnet", "b01", "steps")


def test_seal_parts_tool_prints_every_phase(capsys):
    with T.one_thread():
        rc = T.load("bench_seal_parts_torch").main(["3", "2", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.count("verified=True") == 3
    warm, no_verify = out.split("run_auction (warm)")[1].split(
        "run_auction (warm, no verify)")
    for part, checks in ((warm, True), (no_verify, False)):
        names = re.findall(r"^  (\w+) +[\d.]+ ms$", part, re.M)
        want = list(PHASES[:1]) + (["verify_commit"] if checks else []) + \
            ["round_one"] + (["verify_round_one"] if checks else []) + \
            list(PHASES[2:])
        assert names == want, names
