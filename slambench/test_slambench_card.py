"""Every cell, run as the benchmark runs it, on the card: a short window,
untraced and traced, with ``correct`` true and every metric of the cell
on the result line. Skips without a card; run on one with
``python -m pytest slambench -m cuda``."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from slambench.harness import manifest

CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the card")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell, trace):
    out = subprocess.run(
        [sys.executable, "slambench/run.py", "--workload", cell, "--seed",
         "2147483999", "--seconds", "8", "--trace", str(trace)],
        cwd=manifest.REPO_DIR, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["check"]
    c = manifest.load_cell(cell)
    want = c.per_layer if trace else c.end_to_end
    assert set(res["metrics"]) == {m["name"] for m in want}
