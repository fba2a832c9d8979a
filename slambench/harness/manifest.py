"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. The configuration's file is the entry's ``file``; the traffic mix
is ``traffic/<cell>.json`` and names its driver,
``drivers/<driver>.py``; a per-layer metric is read by
``metrics/<metric>.py``. Adding a cell, a configuration, a traffic mix
or a metric adds files and entries and edits none.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import NamedTuple

BENCH_DIR = Path(__file__).resolve().parent.parent
REPO_DIR = BENCH_DIR.parent
MANIFEST = REPO_DIR / "BENCHMARK.json"

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


class Cell(NamedTuple):
    """One workload, with everything it names loaded."""

    name: str
    chips: int
    config: dict        # the configuration's file
    traffic: dict       # traffic/<cell>.json
    end_to_end: list    # the manifest's metrics this cell reports
    per_layer: list


def load_manifest(path: Path = MANIFEST) -> dict:
    return json.loads(Path(path).read_text())


def check_names(manifest: dict) -> list:
    """The manifest's names and units that break the character rules."""
    bad = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in manifest[key]:
            if not NAME.fullmatch(e["name"]):
                bad.append(e["name"])
            if "unit" in e and not UNIT.fullmatch(e["unit"]):
                bad.append(e["unit"])
            if "source" in e and key != "configs" and e["source"] not in SOURCES:
                bad.append(e["source"])
    for w in manifest["workloads"]:
        bad += [v for v in (w["config"], w["traffic"]) if not NAME.fullmatch(v)]
    for c in manifest["configs"]:
        bad += [k for k in c["reduced"] if not NAME.fullmatch(k)]
    return bad


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, manifest: dict | None = None,
              root: Path = REPO_DIR) -> Cell:
    """The cell ``name`` and the files it names, under the checkout
    ``root``; ``KeyError`` when the manifest has no such cell."""
    manifest = load_manifest() if manifest is None else manifest
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    config = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads((root / BENCH_DIR.name / "traffic"
                          / f"{w['traffic']}.json").read_text())
    e2e = [m for m in manifest["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if m["moves"] in reported and _reports(m, name)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, layer)


def load_module(kind: str, name: str, bench: Path = BENCH_DIR):
    """``<kind>/<name>.py`` under the benchmark folder ``bench``, imported
    by its path (a name may hold ``-`` and ``.``)."""
    path = bench / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.name}")
    spec = importlib.util.spec_from_file_location(
        f"slambench.{kind}.{name.replace('-', '_').replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
