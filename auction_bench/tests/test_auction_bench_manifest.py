"""The manifest against the contract's form, and the harness finding every
configuration, traffic mix and metric by its name."""

import hashlib
import json
import pathlib
import re
import shutil

import pytest

from auction_bench import run as R

ROOT = pathlib.Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_sizes():
    assert set(MANIFEST) == KEYS
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert MANIFEST["paths"] == ["auction_bench"]
    assert 1 <= len(MANIFEST["command"]) <= 32
    assert all(LINE.match(w) for w in MANIFEST["command"])
    cells = len(MANIFEST["workloads"])
    assert 1 <= cells <= 24 and 1 <= len(MANIFEST["configs"]) <= 24


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_units_and_lines(section):
    entries = MANIFEST[section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert LINE.match(e[key]), (e["name"], key)


def test_entry_keys():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("workload", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_finds_its_files(workload):
    cell = R.Cell(workload)
    assert cell.config["protocol"] in ("seal", "ccs22")
    assert cell.mix.name == cell.workload["traffic"]
    assert cell.end_to_end and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(R.load_metric(m["name"]))


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_new_config_traffic_and_metric_are_new_files_only(tmp_path):
    """A later cell adds files and manifest entries; no file the benchmark
    has is edited, and the harness finds the new ones by name."""
    bench = tmp_path / "auction_bench"
    shutil.copytree(ROOT / "auction_bench", bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(bench)
    (bench / "traffic" / "closed-64x32.json").write_text(json.dumps(
        {"n": 64, "c": 32, "bids": "uniform", "loop": "closed", "clients": 1,
         "check_lanes": 32, "profile_auctions": 1}))
    (bench / "configs" / "ccs22-p256.json").write_text(json.dumps(
        {"name": "ccs22-p256", "protocol": "ccs22", "curve": "P-256"}))
    (bench / "metrics" / "auction_p90_s.py").write_text(
        "def read(records):\n"
        "    w = sorted(a['wall_s'] for a in records['auctions'])\n"
        "    return w[int(0.9 * (len(w) - 1))]\n")
    manifest = json.loads(json.dumps(MANIFEST))
    manifest["configs"].append({"name": "ccs22-p256", "source": "x",
                                "file": "auction_bench/configs/ccs22-p256.json",
                                "reduced": [], "why": "x"})
    manifest["workloads"].append({"name": "ccs22-p256-64x32",
                                  "config": "ccs22-p256",
                                  "traffic": "closed-64x32", "chips": 1,
                                  "why": "x"})
    manifest["per_layer"].append({"name": "auction_p90_s", "unit": "s",
                                  "better": "lower", "source": "host_clock",
                                  "layer": "protocol phases outside the steps",
                                  "moves": "auction_s",
                                  "workloads": ["ccs22-p256-64x32"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = R.Cell("ccs22-p256-64x32", root=tmp_path)
    assert (cell.mix.n, cell.mix.c) == (64, 32)
    assert cell.config["curve"] == "P-256"
    names = [m["name"] for m in cell.per_layer]
    assert names == ["auction_p90_s"]
    read = R.load_metric("auction_p90_s", tmp_path)
    assert read({"auctions": [{"wall_s": v} for v in (3, 1, 2)]}) == 2
    after = _digests(bench)
    assert {p: d for p, d in after.items() if p in before} == before
