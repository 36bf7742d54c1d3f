"""A whole run of each cell (set-up, window, check) on the CPU with the
timed path broken underneath: `correct` comes out false under each fault
the cell can have, and true without one."""

import pytest

from auction_bench import faults
from auction_bench import run as R

from ._cpu import seed_where_race_matters, small_cell

CELLS = ["seal-20x32", "ccs22-1024x64"]


def run(workload, fault=None):
    cell = small_cell(workload)
    seed = seed_where_race_matters(cell)
    if fault is None:
        return R.run_cell(cell, seed, 0.0, False, "cpu")
    with faults.planted(fault, cell.config["protocol"]):
        return R.run_cell(cell, seed, 0.0, False, "cpu")


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    result = run(workload)
    assert result["correct"] and result["failed"] == 0
    assert list(result["checks"]) == ["outcome_mismatches", "board_mismatches"]


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(workload, fault):
    result = run(workload, fault)
    assert not result["correct"] and result["failed"] == result["attempted"]
    assert any(v["value"] > v["limit"] for v in result["checks"].values())


def test_faults_are_taken_out_again():
    from privacy_auction_tpu_torch import nizk
    from privacy_auction_tpu_torch.protocols import ccs22, seal

    before = (nizk.sha256, ccs22.sha256, seal.step_body, ccs22.update_race,
              seal.run_auction, ccs22.run_auction)
    for fault in faults.FAULTS:
        for protocol in ("seal", "ccs22"):
            with faults.planted(fault, protocol):
                pass
    assert before == (nizk.sha256, ccs22.sha256, seal.step_body,
                      ccs22.update_race, seal.run_auction, ccs22.run_auction)
