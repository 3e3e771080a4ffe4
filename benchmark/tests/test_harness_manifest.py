"""BENCHMARK.json and the files it names: the contract's shapes, names and
units, and that every cell finds its files."""

import json
import re

import pytest

from benchmark import harness

MAN = harness.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MAN["workloads"]]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entry_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_names_units_and_texts():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MAN[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    for group in ("end_to_end", "per_layer"):
        metric = [e["name"] for e in MAN[group]]
        assert len(metric) == len(set(metric))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports(cell):
    e2e = {m["name"] for m in harness.end_to_end_for(MAN, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = harness.per_layer_for(MAN, cell)
    assert per_layer
    for m in per_layer:
        assert m["moves"] in e2e


def test_moves_and_workloads():
    cells = set(CELLS)
    for m in MAN["per_layer"]:
        for c in m.get("workloads", []):
            assert c in cells
            assert m["moves"] in {e["name"] for e in
                                  harness.end_to_end_for(MAN, c)}
    layers = {}
    for m in MAN["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert all(len(v) >= 1 for v in layers.values())
    for m in MAN["per_layer"]:
        if m["unit"] == "%" and ("_roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    w = harness.find(MAN["workloads"], cell, "workload")
    ctx = harness.make_context(MAN, cell, 1, 1.0, False, "cpu", 0.0)
    assert (harness.BENCH_DIR / "drivers" /
            f"{ctx.traffic['driver']}.py").is_file()
    assert set(ctx.limits)
    for m in harness.per_layer_for(MAN, cell):
        assert (harness.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
    assert w["config"] in {c["name"] for c in MAN["configs"]}


@pytest.mark.parametrize("cfg", MAN["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    """A configuration's file holds its preset as run; ``reduced`` lists
    every key changed from it; every configuration is used by a cell."""
    from sonet_torch.config import PRESETS
    assert cfg["file"].startswith("benchmark/")
    f = json.loads((harness.ROOT / cfg["file"]).read_text())
    preset = PRESETS[f["preset"]]().to_dict()
    for k in ("mesh_shape", "mesh_axes"):
        preset[k] = list(preset[k])
    changed = sorted(k for k in preset if preset[k] != f["config"][k])
    assert changed == sorted(cfg["reduced"]) == sorted(f["reduced"])
    assert f["source"] == cfg["source"]
    assert any(w["config"] == cfg["name"] for w in MAN["workloads"])
