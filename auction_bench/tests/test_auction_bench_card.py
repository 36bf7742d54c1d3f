"""On the card: each cell's run is correct, and its control is not.
Skipped where there is no CUDA device; run them with

    python -m pytest -o addopts="" -p no:cacheprovider -m cuda auction_bench/tests
"""

import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _run(*args):
    return subprocess.run([sys.executable, "-m", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=900)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_is_correct(card, workload):
    out = _run("auction_bench.run", "--workload", workload, "--seed",
               "4000000001", "--seconds", "1", "--trace", "0")
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(card, workload):
    out = _run("auction_bench.control", "--workload", workload, "--faults",
               "altered_hash", "--seeds", "4000000002")
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert not json.loads(out.stdout.strip().splitlines()[-1])["correct"]
