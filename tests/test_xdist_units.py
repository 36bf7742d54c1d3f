"""The repository's conftest.py: under --dist loadfile every test of the
SEAL sweep is a unit of work of its own, every other file one unit."""

import importlib.util
import pathlib
import types

import pytest

from sweep_params import sweep_params

_spec = importlib.util.spec_from_file_location(
    "repo_conftest", pathlib.Path(__file__).resolve().parent.parent / "conftest.py")
units = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(units)

SWEEP = [f"tests/test_sweep.py::test_seal_sweep[{n}-{c}]"
         for n, c in sweep_params()]
OTHER = ["tests/test_seal.py::test_a", "tests/test_seal.py::test_b",
         "tests/test_seal.py::test_c", "tests/test_sweep_ccs22.py::test_x[1-2]",
         "auction_bench/tests/test_run.py::TestRun::test_y"]


class _Node:
    def __init__(self, name):
        self.gateway = types.SimpleNamespace(id=name)
        self.shutting_down = False
        self.sent = []

    def send_runtest_some(self, indexes):
        self.sent.append(indexes)

    def shutdown(self):
        self.shutting_down = True


def _config(dist):
    values = {"dist": dist, "tx": ["2*popen"]}
    return types.SimpleNamespace(
        getvalue=values.__getitem__,
        option=types.SimpleNamespace(loadscopereorder=True))


def test_scope_spreads_only_the_seal_sweep():
    assert len(set(SWEEP)) == 6
    assert [units.scope(i) for i in SWEEP] == SWEEP
    assert [units.scope(i) for i in OTHER] == [
        "tests/test_seal.py"] * 3 + ["tests/test_sweep_ccs22.py",
                                     "auction_bench/tests/test_run.py"]


@pytest.mark.parametrize("dist", ["no", "load", "loadscope", "each"])
def test_other_modes_keep_xdist_scheduler(dist):
    assert units.pytest_xdist_make_scheduler(_config(dist), None) is None


def test_loadfile_hands_out_sweep_tests_one_by_one():
    sched = units.pytest_xdist_make_scheduler(_config("loadfile"), None)
    collection = OTHER[:3] + SWEEP
    nodes = [_Node("gw0"), _Node("gw1")]
    for node in nodes:
        sched.add_node(node)
        sched.add_node_collection(node, collection)
    sched.schedule()
    # the three-test file first, whole; then one sweep pair a unit
    assert nodes[0].sent == [[0, 1, 2]]
    assert nodes[1].sent == [[3], [4]]
    assert list(sched.workqueue) == SWEEP[2:]
