"""tools/run_sweep_torch.py, the reference-parity sweep through the port's
drivers, over a two-pair params file written by tools/gen_tests.py (n <= 3,
c <= 3), on the CPU: each pair's verified SEAL and CCS22 auctions find the
plaintext maximum and the tool exits 0."""

import subprocess
import sys

import torch_tool_cases as T


def test_sweep_tool_finds_every_pairs_maximum(tmp_path, capsys):
    params = tmp_path / "params.txt"
    subprocess.run([sys.executable, str(T.TOOLS / "gen_tests.py"), "--tests",
                    "2", "--bidders_max", "3", "--bitslen_max", "3", "--out",
                    str(params), "--seed", "8"], check=True)
    pairs = [tuple(map(int, ln.split())) for ln in params.read_text().split("\n")
             if ln.strip()]
    assert len(pairs) == 2 and all(n <= 3 and c <= 3 for n, c in pairs)
    with T.one_thread():
        rc = T.load("run_sweep_torch").main(["--params", str(params),
                                             "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.count("SEAL ok") == 2 and out.count("CCS22 ok") == 2
    assert "# PASS: 2/2 pairs" in out
