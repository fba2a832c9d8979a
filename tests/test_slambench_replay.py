"""The benchmark's dense replay cell (``desk-dense512-replay``: the driver
``slambench/drivers/replay.py`` and its check) end to end on the CPU at a
tiny size, through ``Context.overrides``: a sound run is correct and
checks ICP frames and a fusion; each planted fault of
``harness/plants_dense.py`` turns ``correct`` false; a traced run records
the shell's dense spans, counters and stage marks, and each of the cell's
six readers reads them. No JAX:

    python -m pytest tests/test_slambench_replay.py -q
"""
import functools
import json
import sys
from pathlib import Path

import pytest
import torch

from kbslam_torch.utils import profiling

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from slambench import tiny  # noqa: E402
from slambench.harness import manifest, plants_dense  # noqa: E402
from slambench.harness.compare import Gaps, judge  # noqa: E402
from slambench.harness.compare_dense import DenseGaps  # noqa: E402
from slambench.harness.context import Context  # noqa: E402

torch.set_num_threads(1)

CELL = "desk-dense512-replay"
READERS = ("dense_icp_ms", "dense_icp_pack_ms", "dense_icp_roofline",
           "dense_fuse_ms", "dense_fuse_roofline", "dense_frame_syncs")
# a 3 m x 3 m x 1 m box of 6.25 cm voxels in front of each anchor, a
# submap per keyframe, a ring of 6
DENSE = {"enabled": True, "dims": [48, 48, 16], "voxel_size": 0.0625,
         "origin": [-1.5, -1.5, 2.0], "truncation": 0.2,
         "submap_every": 1, "max_submaps": 6}


def context(seed: int = 5, trace: bool = False) -> Context:
    """The cell at 160x120 (``tiny.CONFIG``'s camera and map) with a small
    atlas, two 8-frame stretches, a short warm-up to 3 submaps; traced,
    the profiler holds the window's first 12 frames."""
    cell = manifest.load_cell(CELL)
    traffic = json.loads(json.dumps(cell.traffic))
    traffic["check"].update(stretches=2, stretch_frames=8, within_frames=24,
                            slab_rows=16)
    traffic["warmup"] = {"min_frames": 2, "submaps": 3, "max_frames": 80}
    traffic["trace"] = {"start": 0, "frames": 12}
    over = {k: v for k, v in json.loads(json.dumps(tiny.CONFIG)).items()
            if k != "streams"}
    over["slam"]["dense"] = DENSE
    over["slam"]["dense_icp"] = {"mode": "refine"}
    return Context(cell._replace(traffic=traffic), seed, 1.0, trace,
                   torch.device("cpu"), over)


def _run(ctx):
    res = manifest.load_module("drivers", "replay").run(ctx)
    return judge(res.numbers, ctx.cell.traffic["check"]["limits"])[0], res


@functools.lru_cache(maxsize=1)
def _traced():
    """One sound traced run: (correct, result, the recorder's records)."""
    profiling.disable()
    profiling.reset()
    ok, res = _run(context(trace=True))
    records = profiling.records()
    profiling.reset()
    return ok, res, records


def test_the_cells_limits_are_numbers_the_check_reads():
    limits = manifest.load_cell(CELL).traffic["check"]["limits"]
    dense = set(DenseGaps().numbers())
    assert set(limits) <= set(Gaps().numbers()) | dense
    assert {"icp_mm", "icp_mdeg", "tsdf_gap", "weight_pct"} <= set(limits)
    assert {"icp_valid_pct", "icp_decisions"} <= dense


def test_a_sound_run_is_correct_and_checks_the_dense_stages():
    ok, res, _ = _traced()
    assert ok, res.numbers
    line = next(x for x in res.info if x.startswith("check:"))
    icp_frames = int(line.split(" ICP frames")[0].rsplit(" ", 1)[1])
    fusions = int(line.split(" fusions")[0].rsplit(" ", 1)[1])
    assert icp_frames > 0 and fusions > 0, line
    assert res.attempted >= 24 and res.failed == 0
    assert set(res.metrics) == {"frames_per_s", "setup_s"}


@pytest.mark.parametrize("plant", sorted(plants_dense.PLANTS))
def test_a_dense_fault_is_not_correct(monkeypatch, plant):
    plants_dense.PLANTS[plant](monkeypatch.setattr)
    ok, res = _run(context())
    assert not ok, res.numbers


def test_the_trace_records_the_dense_spans_counters_and_marks():
    _, res, recs = _traced()
    names = {(r["kind"], r["name"]) for r in recs}
    for want in (("span", "shell.icp"), ("span", "shell.fuse"),
                 ("count", "dense.icp_solves"),
                 ("count", "dense.icp_accepted"),
                 ("count", "dense.fusions"), ("count", "dense.submaps_opened"),
                 ("stage", "icp_pack"), ("stage", "icp_gn"),
                 ("stage", "fuse")):
        assert want in names, want
    spans = {r["id"]: r for r in recs if r["kind"] == "span"}
    for r in spans.values():
        if r["name"] in ("shell.icp", "shell.fuse"):
            assert spans[r["parent"]]["name"] == "shell.ticks"
    # an ICP frame reads the track output, the six reads of its slot
    # choice and its result
    syncs = {}
    for r in recs:
        if r["kind"] == "count" and r["name"] == "shell.syncs":
            syncs[r["frame"]] = syncs.get(r["frame"], 0) + r["n"]
    icp = {r["frame"] for r in recs
           if r["kind"] == "count" and r["name"] == "dense.icp_solves"}
    assert icp and all(syncs[f] == 8 for f in icp), syncs


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_a_recorded_run(name):
    _, res, recs = _traced()
    reader = manifest.load_module("metrics", name)
    v = reader.read(res.layer, records=recs)
    assert v is not None and v > 0, (name, v)
    assert reader.read(res.layer, records=[]) is None


@pytest.mark.parametrize("name", READERS[:3])
def test_the_icp_readers_read_nothing_where_no_icp_ran(name):
    _, res, recs = _traced()
    left = [r for r in recs if not (
        (r["kind"] == "stage" and r["name"].startswith("icp_"))
        or (r["kind"] == "marks" and r["name"] == "icp_atlas"))]
    assert manifest.load_module("metrics", name).read(res.layer,
                                                      records=left) is None
