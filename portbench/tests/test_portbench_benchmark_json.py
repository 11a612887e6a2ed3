"""BENCHMARK.json against the contract's shape: its keys, names, units,
files and limits."""

import json
import os
import re

import pytest

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["command"]) <= 32
    assert all(_line(w) for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


def test_configs(bench):
    names = [c["name"] for c in bench["configs"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(bench["paths"][0] + "/")
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    assert len({c["file"] for c in bench["configs"]}) == len(names)


def test_workloads(bench):
    cells = bench["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for key in ("name", "config", "traffic"):
            assert NAME.match(w[key]), w[key]
        assert w["chips"] in (1, 4) and _line(w["why"])
        for folder, stem in (("workloads", w["name"]),
                             ("traffic", w["traffic"])):
            assert os.path.exists(os.path.join(
                spec.HERE, folder, stem + ".json"))


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e, layer = bench["end_to_end"], bench["per_layer"]
    names = [m["name"] for m in e2e + layer]
    assert len(names) == len(set(names))
    assert "setup_s" in names and 1 <= len(e2e) <= 16
    assert 1 <= len(layer) <= 128
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    by_name = {m["name"]: m for m in e2e}
    for m in layer:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _line(m["layer"]) and m["moves"] in by_name
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in by_name[m["moves"]].get("workloads", cells)
    for m in e2e + layer:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        folder = "layer_metrics" if m in layer else "e2e_metrics"
        assert spec.reader(folder, m["name"]).read
        for cell in m.get("workloads", []):
            assert cell in cells
    for cell in cells:
        c = spec.Cell(cell)
        assert any(m["name"] == "setup_s" for m in c.end_to_end)
        assert len(c.end_to_end) >= 2 and c.per_layer


def test_files_under_paths_are_named_from_name_characters(bench):
    for root, _, files in os.walk(spec.HERE):
        if "__pycache__" in root:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), spec.ROOT)
            assert PATH.match(rel), rel
