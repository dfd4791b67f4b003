"""BENCHMARK.json keeps to the contract's form, and every file a cell
needs is found by its name."""

import json
import re

import _paths  # noqa: F401
import pytest

from benchmark.lib import common

MAN = json.loads((common.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len((common.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    names = [c["name"] for c in MAN["configs"]] + [w["name"] for w in MAN["workloads"]]
    names += [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    names += [w["config"] for w in MAN["workloads"]] + [w["traffic"] for w in MAN["workloads"]]
    names += [k for c in MAN["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    metrics = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(set(metrics)) == len(metrics)


def test_entry_keys_and_bounds():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in MAN["end_to_end"])
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_files_found_by_name(cell):
    c = common.find_cell(cell, MAN)
    w = next(w for w in MAN["workloads"] if w["name"] == cell)
    assert cell == f"{w['traffic']}.{w['config']}" == f"{w['traffic']}.{c.config['name']}"
    assert c.driver.setup and c.driver.window and c.driver.check
    assert c.asset("quantizer").exists() and c.asset("sampler").exists()
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in e2e
        assert callable(common.metric_reader(m["name"]).read)
    assert "trace" in c.mix


def test_assets_match_their_sums():
    common.check_assets()
