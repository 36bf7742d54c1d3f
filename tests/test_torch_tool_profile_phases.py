"""tools/profile_phases_torch.py at 3x2 on the CPU: every SEAL program is
timed, the extrapolated shares add up to the total, and --json writes the
JAX tool's keys."""

import json

import torch_tool_cases as T

PROGRAMS = ("commit", "verify_commit", "round1", "verify_round1", "avnet",
            "round2_s1", "verify_round2_s1", "round2_s2", "verify_round2_s2",
            "round3")


def test_profile_phases_tool_times_every_program(tmp_path, capsys):
    out = tmp_path / "phases.json"
    with T.one_thread():
        rc = T.load("profile_phases_torch").main(
            ["3", "2", "--device", "cpu", "--reps", "1", "--json", str(out)])
    assert rc == 0
    got = json.loads(out.read_text())
    assert set(got) == {"n", "c", "device", "card", "dispatch_s",
                        "extrapolated_total_s", "shares_s"}
    assert (got["n"], got["c"], got["device"]) == (3, 2, "cpu")
    assert tuple(got["dispatch_s"]) == PROGRAMS
    assert all(s > 0 for s in got["dispatch_s"].values())
    assert set(got["shares_s"]) == {"commit", "round1", "avnet", "round2_gen",
                                    "round2_verify", "round3"}
    total = sum(got["shares_s"].values())
    assert abs(total - got["extrapolated_total_s"]) < 1e-9 * total
    printed = capsys.readouterr().out
    assert all(f"{k:20s}" in printed for k in PROGRAMS)
