"""The port's recorder (``kbslam_torch/utils/profiling.py``) on the CPU:
off it records nothing; on (``enable``, or inside ``torch.profiler``) it
records the shells' spans and counters and the programs' stage marks,
and the programs' results are bit-equal with it on and off; the
benchmark's readers of those records; ``cli --trace DIR``. The marks
inside CUDA graphs are held on the card by tests/test_torch_cuda.py.
This file imports no JAX:

    python -m pytest tests/test_torch_profiling.py -q
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from kbslam_torch import config as C
from kbslam_torch.geom.camera import Intrinsics
from kbslam_torch.io.synthetic import render_sequence
from kbslam_torch.pipeline import clone_state, init_state, make_track_step
from kbslam_torch.utils import profiling

REPO = Path(__file__).resolve().parent.parent
torch.set_num_threads(1)
H, W = 120, 160
TRACK_STAGES = ["frontend", "match", "pnp", "map"]


@pytest.fixture(autouse=True)
def recorder():
    """A recorder that is off and empty before and after each test."""
    profiling.disable()
    profiling.reset()
    yield profiling
    profiling.disable()
    profiling.reset()


def small_cfg():
    """160x120 frames, a small ORB and map, and a keyframe policy that
    inserts within the six frames of ``seq``."""
    cfg = C.SLAMConfig()
    return cfg.replace(
        image_height=H, image_width=W,
        orb=C.OrbConfig(num_features=300, num_levels=4, max_features=320),
        map=dataclasses.replace(cfg.map, max_keyframes=8,
                                max_map_points=2048),
        policy=C.KeyframePolicyConfig(min_frame_gap=2,
                                      rotation_threshold_deg=1.0,
                                      translation_threshold=0.01))


@pytest.fixture(scope="module")
def seq():
    return render_sequence(num_frames=16, height=H, width=W, fx=130.0)


def _frame(seq, i):
    return (torch.from_numpy(seq.rgb[i]),
            torch.from_numpy(seq.depth[i].astype(np.int32)))


def _leaves(tree):
    from kbslam_torch.device import tensor_leaves

    return list(tensor_leaves(tree))


def _bit_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _kinds(kind, name=None):
    return [r for r in profiling.records()
            if r["kind"] == kind and (name is None or r["name"] == name)]


def _track(seq, frames, on):
    """``frames`` tracking steps from an empty map, the recorder ``on`` or
    off: (the state after, the outputs)."""
    cfg = small_cfg()
    step = make_track_step(cfg, Intrinsics.from_matrix(seq.K),
                           use_mask=False)
    st, outs = init_state(cfg, "cpu"), []
    if on:
        profiling.enable()
    for i in range(frames):
        with profiling.span("test.frame", i):
            st, out = step(st, *_frame(seq, i))
        outs.append(out)
    profiling.disable()
    return st, outs


def test_off_records_nothing(seq):
    """Off: ``span`` is the one shared null context, counters and marks
    return at once, and a tracking step leaves no record."""
    assert not profiling.enabled()
    a, b = profiling.span("x", 1), profiling.span("y")
    assert a is b
    with a:
        profiling.count("c", 3)
        profiling.mark(None, torch.zeros(1))
        profiling.mark("s", torch.zeros(1))
    _track(seq, 2, on=False)
    assert profiling.records() == []
    assert profiling.summary() == {}


def test_on_inside_the_profiler_and_its_spans_in_the_trace():
    """On while ``torch.profiler.profile`` runs and off after; each span
    is a ``kbslam.<name>`` range of the profiler's events, nested as the
    recorder's parents say, and inner spans carry the outer one's
    frame id."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.enabled()
        with profiling.span("outer", 7):
            with profiling.span("inner"):
                torch.ones(8).sum()
                profiling.count("work", 2)
    assert not profiling.enabled()
    with profiling.span("after", 8):
        pass
    spans = {r["name"]: r for r in _kinds("span")}
    assert set(spans) == {"outer", "inner"}
    assert spans["inner"]["parent"] == spans["outer"]["id"]
    assert spans["outer"]["parent"] is None
    assert spans["inner"]["frame"] == spans["outer"]["frame"] == 7
    (c,) = _kinds("count", "work")
    assert c["n"] == 2 and c["frame"] == 7
    events = {e.name: e for e in prof.events()
              if e.name.startswith(profiling.SPAN_PREFIX)}
    assert set(events) == {"kbslam.outer", "kbslam.inner"}
    assert events["kbslam.inner"].cpu_parent.name == "kbslam.outer"


def test_track_step_stages_in_order_and_bit_equal(seq):
    """``track_step`` with the recorder on: ``frontend``, ``match``,
    ``pnp`` and ``map`` once per frame, in that order, each inside its
    frame's span; state and outputs bit-equal to a run with it off."""
    st_off, out_off = _track(seq, 3, on=False)
    st_on, out_on = _track(seq, 3, on=True)
    _bit_equal(st_off, st_on)
    _bit_equal(tuple(out_off), tuple(out_on))
    stages = _kinds("stage")
    assert [r["name"] for r in stages] == TRACK_STAGES * 3
    assert [r["frame"] for r in stages] == [f for f in range(3)
                                            for _ in TRACK_STAGES]
    frames = {r["frame"]: r for r in _kinds("span", "test.frame")}
    for r in stages:
        assert r["graph"] is None and r["clock"] == "host"
        f = frames[r["frame"]]
        assert f["start_ns"] <= r["start_ns"] <= r["end_ns"] <= f["end_ns"]
    for a, b in zip(stages, stages[1:]):
        if a["frame"] == b["frame"]:
            assert a["end_ns"] == b["start_ns"]


def test_track_step_batched_stages_in_order_and_bit_equal(seq):
    """The same for ``track_step_batched`` over two streams."""
    from kbslam_torch.parallel.multistream import batched_init_state
    from kbslam_torch.pipeline import track_step_batched
    from kbslam_torch.pnp.ransac import hash_sampler

    cfg, intr, S = small_cfg(), Intrinsics.from_matrix(seq.K), 2

    def run(on):
        st = batched_init_state(cfg, S, "cpu")
        if on:
            profiling.enable()
        outs = []
        for t in range(3):
            rgb = torch.from_numpy(np.stack([seq.rgb[t], seq.rgb[t + 1]]))
            dep = torch.from_numpy(np.stack(
                [seq.depth[t], seq.depth[t + 1]]).astype(np.int32))
            counters = st.frame_count * S + torch.arange(S, dtype=torch.int32)
            st, out = track_step_batched(st, rgb, dep, None, intr, cfg,
                                         hash_sampler(0, counters))
            outs.append(out)
        profiling.disable()
        return st, outs

    st_off, out_off = run(False)
    st_on, out_on = run(True)
    _bit_equal(st_off, st_on)
    _bit_equal(tuple(out_off), tuple(out_on))
    assert [r["name"] for r in _kinds("stage")] == TRACK_STAGES * 3


def test_local_ba_stages_trips_and_bit_equal(seq):
    """``local_ba``: ``setup``, ``lm`` and ``writeback`` in order, the map
    and stats bit-equal with the recorder on and off; through the shell,
    ``ba.live_trips`` is each solve's ``BAStats.iterations`` and
    ``ba.trips_run`` its ``max_iterations``."""
    from kbslam_torch.ba.local_ba import local_ba
    from kbslam_torch.slam import SLAM

    cfg = small_cfg()
    st, _ = _track(seq, 6, on=False)
    assert int(st.map.num_kf) >= 2
    intr = Intrinsics.from_matrix(seq.K)
    m_off, s_off = local_ba(clone_state(st).map, intr, cfg.ba)
    profiling.enable()
    m_on, s_on = local_ba(clone_state(st).map, intr, cfg.ba)
    profiling.disable()
    _bit_equal((m_off, s_off), (m_on, s_on))
    assert [r["name"] for r in _kinds("stage")] == ["setup", "lm",
                                                    "writeback"]
    profiling.reset()
    slam = SLAM(cfg, seq.K, use_mask=False, device="cpu")
    profiling.enable()
    for i in range(6):
        slam.process(seq.rgb[i], seq.depth[i])
    profiling.disable()
    assert slam.ba_stats
    assert [r["n"] for r in _kinds("count", "ba.live_trips")] == \
        [s["iterations"] for s in slam.ba_stats]
    assert [r["n"] for r in _kinds("count", "ba.trips_run")] == \
        [cfg.ba.max_iterations] * len(slam.ba_stats)


def test_slam_process_spans_and_syncs(seq):
    """``SLAM.process``: one ``shell.process`` per frame with its frame
    index, the shell's spans inside it, the upload and the track stages
    per frame, one ``shell.syncs`` per frame and one more per solve, and
    every span's self time (its length less its children's) >= 0; the
    trajectory equals a run with the recorder off."""
    from kbslam_torch.slam import SLAM

    def run(on):
        slam = SLAM(small_cfg(), seq.K, use_mask=False, device="cpu")
        if on:
            profiling.enable()
        for i in range(6):
            slam.process(seq.rgb[i], seq.depth[i])
        profiling.disable()
        return slam

    off, on = run(False), run(True)
    np.testing.assert_array_equal(np.stack(off.frame_poses),
                                  np.stack(on.frame_poses))
    spans = _kinds("span")
    tops = [r for r in spans if r["name"] == "shell.process"]
    assert [r["frame"] for r in tops] == list(range(6))
    top_ids = {r["id"] for r in tops}
    for r in spans:
        if r["name"] != "shell.process":
            assert r["parent"] in top_ids
    names = {r["name"] for r in spans}
    assert {"shell.upload", "shell.track", "shell.ba", "shell.ticks",
            "shell.record"} <= names
    per = {f: 0 for f in range(6)}
    for r in _kinds("count", "shell.syncs"):
        per[r["frame"]] += r["n"]
    solves = {d["frame"] for d in on.diagnostics if d["ran_ba"]}
    assert per == {f: 1 + (f in solves) for f in range(6)}
    assert [r["frame"] for r in _kinds("stage", "upload")] == list(range(6))
    assert [r["name"] for r in _kinds("stage") if r["name"] in TRACK_STAGES] \
        == TRACK_STAGES * 6
    children = {}
    for r in spans:
        children.setdefault(r["parent"], []).append(r)
    for r in spans:
        inner = sum(c["end_ns"] - c["start_ns"]
                    for c in children.get(r["id"], []))
        assert r["end_ns"] - r["start_ns"] - inner >= 0


def test_chunked_stream_stages_per_frame_and_drain_apart(seq):
    """``ChunkedStream``: the four stages once for each frame of each
    chunk, the feed's spans under the chunk's index, and ``stream.drain``
    a span of its own, outside ``stream.dispatch``; results equal a run
    with the recorder off."""
    from kbslam_torch.streaming import ChunkedStream

    cfg, intr = small_cfg(), Intrinsics.from_matrix(seq.K)

    def run(on):
        cs = ChunkedStream(cfg, intr, init_state(cfg, "cpu"), chunk=2)
        if on:
            profiling.enable()
        got = []
        for i in range(6):
            got += cs.feed(seq.rgb[i], seq.depth[i])
        profiling.disable()
        return got + cs.flush()

    off, on = run(False), run(True)
    assert [d["pose_t"].tolist() for d in off] == \
        [d["pose_t"].tolist() for d in on]
    assert [r["name"] for r in _kinds("stage")] == TRACK_STAGES * 6
    dispatch = _kinds("span", "stream.dispatch")
    assert [r["frame"] for r in dispatch] == [0, 1, 2]
    drains = _kinds("span", "stream.drain")
    assert [r["frame"] for r in drains] == [1, 2]
    ids = {r["id"] for r in dispatch}
    for r in drains:
        assert r["parent"] not in ids and all(
            r["start_ns"] >= d["end_ns"] or r["end_ns"] <= d["start_ns"]
            for d in dispatch)
    stage = _kinds("span", "stream.stage")
    assert [r["frame"] for r in stage] == [0, 0, 1, 1, 2, 2]


def _stage(name, graph, ms, frame, step=0):
    return dict(kind="stage", name=name, graph=graph, step=step, start_ns=0,
                end_ns=int(ms * 1e6), frame=frame, clock="device")


def _marks(graph, start_ms, end_ms, frame):
    return dict(kind="marks", name=graph, start_ns=int(start_ms * 1e6),
                end_ns=int(end_ms * 1e6), frame=frame, clock="device")


def _hand_records():
    """Records as the recorder keeps them over three traced frames of
    the shell and two of each stepping graph."""
    recs = []
    for f, base in enumerate((1.0, 2.0, 4.0)):
        recs.append(dict(kind="span", name="shell.process", frame=f))
        recs += [_stage(s, "track", base * (k + 1), f)
                 for k, s in enumerate(TRACK_STAGES)]
        recs.append(_stage("upload", "shell", 0.1 * base, f))
        recs.append(_stage("lm", "ba", 20.0 + f, f))
        # upload 0-1, track 2-(5+f), ba (6+f)-(10+f): 2 ms of no marked work
        recs += [_marks("shell", 0, 1, f), _marks("track", 2, 5 + f, f),
                 _marks("ba", 6 + f, 10 + f, f)]
        recs += [dict(kind="count", name="shell.syncs", n=1, frame=f)] * \
            (1 + (f == 2))
        recs.append(dict(kind="count", name="ba.live_trips", n=5 + 3 * f,
                         frame=f))
    for g, base in (("multistream_step", 10.0), ("chunk", 30.0)):
        recs += [_stage(s, g, base + k, 100, step=j)
                 for j in range(2) for k, s in enumerate(TRACK_STAGES)]
    # a host mark is no device stage
    recs.append(dict(_stage("frontend", None, 1000.0, 0), clock="host"))
    return recs


READINGS = {
    "track_frontend_ms": 2.0, "track_match_ms": 4.0, "track_pnp_ms": 6.0,
    "track_map_ms": 8.0, "shell_upload_ms": 0.2, "shell_gap_ms": 2.0,
    "shell_syncs": 1.0, "ba_lm_ms": 21.0, "ba_live_trips": 8.0,
    # the median over the two graphs' steps (10, 10, 30, 30 and so on)
    "step_frontend_ms": 20.0, "step_match_ms": 21.0, "step_pnp_ms": 22.0,
    "step_map_ms": 23.0,
}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_benchmark_reader_on_records_by_hand(name):
    """Each of the benchmark's readers of the program's records, found by
    name, gives the median it defines, and None on no records."""
    sys.path.insert(0, str(REPO))
    from slambench.harness import manifest

    reader = manifest.load_module("metrics", name)
    assert reader.read({}, records=_hand_records()) == \
        pytest.approx(READINGS[name])
    assert reader.read({}, records=[]) is None
    assert reader.read({}) is None        # the recorder holds nothing


def test_cli_trace_writes_spans_and_prints_the_table(tmp_path):
    """``python -m kbslam_torch.cli --trace DIR`` on the CPU: the Chrome
    trace and ``spans.json`` in DIR, the table on standard error, the
    summary still the last line of standard output."""
    d = tmp_path / "trace"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "kbslam_torch.cli", "--device", "cpu",
         "--frames", "4", "--width", str(W), "--height", str(H),
         "--trace", str(d)], capture_output=True, text=True, cwd=REPO,
        env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1])["frames"] == 4
    recs = json.loads((d / "spans.json").read_text())
    tops = [x for x in recs if x["kind"] == "span"
            and x["name"] == "shell.process"]
    assert [x["frame"] for x in tops] == [0, 1, 2, 3]
    assert (d / profiling.TRACE_FILE).is_file()
    assert "shell.process" in r.stderr and "count" in r.stderr
