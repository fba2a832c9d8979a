"""``BENCHMARK.json`` against the rules it is written to, and the
harness's finding of files by name (CPU, no card)."""
from __future__ import annotations

import json
import shutil

import pytest

from slambench.harness import manifest
from slambench.harness.compare import Gaps

M = manifest.load_manifest()
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def test_top_level_keys_and_sizes():
    assert set(M) == TOP
    assert 1 <= len(M["paths"]) <= 16 and 1 <= len(M["configs"]) <= 24
    assert 1 <= len(M["workloads"]) <= 24 and 1 <= len(M["end_to_end"]) <= 16
    assert 1 <= len(M["per_layer"]) <= 128
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) <= 64 * 1024
    assert all(p.startswith("slambench") for p in M["command"][1:2])


def test_names_and_units_keep_to_the_characters():
    assert manifest.check_names(M) == []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in M[key]]
        assert len(names) == len(set(names)), key


@pytest.mark.parametrize("entry,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source",
                    "workloads"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves",
                   "workloads"}),
])
def test_entries_carry_only_their_keys(entry, keys):
    for e in M[entry]:
        assert set(e) <= keys, e["name"]
        for text in ("why", "layer", "source"):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text]


def test_metrics_and_bounds():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in M["workloads"]}
    for m in M["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        for c in m["workloads"]:
            assert "workloads" not in e2e[m["moves"]] or \
                c in e2e[m["moves"]]["workloads"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_every_cell_finds_its_files(cell):
    c = manifest.load_cell(cell)
    assert c.chips == 1
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    manifest.load_module("drivers", c.traffic["driver"])
    for m in c.per_layer:
        assert callable(manifest.load_module("metrics", m["name"]).read)
    assert set(c.traffic["check"]["limits"]) <= set(Gaps().numbers())


def test_configs_are_each_used_and_name_their_cuts():
    used = {w["config"] for w in M["workloads"]}
    files = [c["file"] for c in M["configs"]]
    assert used == {c["name"] for c in M["configs"]}
    assert len(files) == len(set(files))
    for c in M["configs"]:
        data = json.loads((manifest.REPO_DIR / c["file"]).read_text())
        assert data["source"] == c["source"]
        for key in c["reduced"]:
            group = data
            for part in key.split("."):
                assert part in group, (c["name"], key)
                group = group[part]
        assert "assumed" in data


def test_new_files_are_found_without_editing(tmp_path):
    """A configuration, a traffic mix and a metric added as files, with
    manifest entries, are found by name."""
    bench = tmp_path / "slambench"
    for d in ("configs", "traffic", "metrics"):
        (bench / d).mkdir(parents=True)
    (bench / "configs" / "new-cfg.json").write_text(json.dumps(
        {"source": "x", "camera": {}, "assumed": {}}))
    (bench / "traffic" / "new-mix.json").write_text(json.dumps(
        {"driver": "live", "check": {"limits": {}}}))
    (bench / "metrics" / "new_metric.py").write_text(
        "def read(layer):\n    return layer.get('x')\n")
    m = json.loads(json.dumps(M))
    m["configs"].append({"name": "new-cfg", "source": "x",
                         "file": "slambench/configs/new-cfg.json",
                         "reduced": [], "why": "x"})
    m["workloads"].append({"name": "new-cell", "config": "new-cfg",
                           "traffic": "new-mix", "chips": 1, "why": "x"})
    m["per_layer"].append({"name": "new_metric", "unit": "ms",
                           "better": "lower", "source": "device_trace",
                           "layer": "step", "moves": "setup_s",
                           "workloads": ["new-cell"]})
    c = manifest.load_cell("new-cell", m, root=tmp_path)
    assert c.traffic["driver"] == "live"
    assert [x["name"] for x in c.per_layer] == ["new_metric"]
    reader = manifest.load_module("metrics", "new_metric", bench)
    assert reader.read({"x": 3.0}) == 3.0
    shutil.rmtree(bench)
