"""The port's loop closure and relocalization (kbslam_torch/loop/) against
the JAX reference (kbslam/loop/), on the CPU with one thread.

The same inputs, made from seeds with numpy, go into both packages; where
RANSAC runs, the port is given the minimal sets the reference draws from
its key (the sampler hook), so the two differ only by float32 rounding.
Bounds:

- pose graph on the circle graph of tests/test_loop.py: poses within
  1e-4 m and 1e-4 rad, equal ``accepted``; padded to 20 nodes, the same
  poses (padding inert). Padded, the trip where the 1e-9 relative stop
  fires moves with rounding, so there poses and cost are compared, not
  counts;
- word signatures and ``detect_loop``'s slot and ``found``: exact;
- the probe (detect + verify) on a tracked map: equal ``found``, slot,
  ``ok`` and inliers, relative pose within 1e-4; a stale query id is a
  no-op in both;
- ``close_loop``: keyframe poses and landmarks within 1e-4; with
  ``loop_ok`` False the map comes back unchanged (1e-5, the reference's
  own test);
- ``reloc_step`` on a small map: equal success, slot and inserted
  keyframe id, its pose within 1 cm and 0.5 deg (the tracking step's
  parity bound: the two extractors place keypoints 1e-3 px apart);
- the runner's pending queue and stale probe, as tests/test_loop.py:332-419;
- the ordinals (the reference's fault, see ``LoopCloser``): after a
  resume the reference probes keyframe 0, the port the newest; after a
  chunked relocalization insertion the reference's runner falls one
  behind the map, the port's does not.

The end-to-end gates of tests/test_loop.py on the port's own shells
(corridor out-and-back, lost-and-found per frame and chunked) are in
tests/test_torch_loop_e2e.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbslam.geom.camera import Intrinsics as JIntr
from kbslam.io.synthetic import render_sequence
from kbslam.loop import closure as jclosure
from kbslam.loop import detect as jdetect
from kbslam.loop.pose_graph import make_pose_graph_solver as j_solver
from kbslam.loop.reloc import reloc_step as j_reloc_step
from kbslam.mapping.state import MapState as JMapState
from kbslam.pipeline import TrackState as JTrackState
from kbslam_torch import convert
from kbslam_torch.geom.camera import Intrinsics as TIntr
from kbslam_torch.geom.se3 import SE3 as TSE3
from kbslam_torch.loop import closure as tclosure
from kbslam_torch.loop import detect as tdetect
from kbslam_torch.loop.pose_graph import PoseGraph as TPoseGraph
from kbslam_torch.loop.pose_graph import make_pose_graph_solver as t_solver
from kbslam_torch.loop.reloc import FRAME_OFFSET, make_reloc_step
from kbslam_torch.loop.runner import LoopCloser as TLoopCloser
from kbslam_torch.mapping.state import empty_map as t_empty_map
from kbslam_torch.slam import SLAM as TSLAM
from test_loop import _circle_graph
from test_pipeline import small_cfg
from test_torch_pipeline import jax_sampler

torch.set_num_threads(1)
I32 = torch.int32


def _t(x, dtype=None):
    return torch.tensor(np.asarray(x), dtype=dtype)


def _rot_gap(qa, qb):
    """Rotation angles (rad) between quaternion rows, float64."""
    a = np.asarray(qa, np.float64)
    b = np.asarray(qb, np.float64)
    dot = np.abs(np.sum(a * b, -1)) / (np.linalg.norm(a, axis=-1)
                                      * np.linalg.norm(b, axis=-1))
    return 2 * np.arccos(np.clip(dot, -1, 1))


# --- pose graph --------------------------------------------------------------

def _solve_both(pad_to):
    g, _, _ = _circle_graph(pad_to=pad_to)
    gj, sj = j_solver()(g)
    gt, st = t_solver()(convert.tuple_to_torch(g, TPoseGraph, "cpu"))
    return gj, sj, gt, st


def test_pose_graph_matches_reference():
    gj, sj, gt, st = _solve_both(None)
    assert np.abs(gt.node_t.numpy() - np.asarray(gj.node_t)).max() < 1e-4
    assert _rot_gap(gt.node_q.numpy(), gj.node_q).max() < 1e-4
    assert int(st.accepted) == int(sj.accepted) >= 3
    assert float(st.final_cost) < 0.1 * float(st.initial_cost)
    np.testing.assert_allclose(float(st.final_cost), float(sj.final_cost),
                               rtol=1e-4)
    # the gauge: node 0 untouched
    assert torch.equal(gt.node_t[0], _t(_circle_graph()[0].node_t)[0])


def test_pose_graph_padding_is_inert():
    gj, sj, gt, st = _solve_both(20)
    _, _, g12, _ = _solve_both(None)
    for got in (np.asarray(gj.node_t)[:12], g12.node_t.numpy()):
        assert np.abs(gt.node_t.numpy()[:12] - got).max() < 1e-4
    assert _rot_gap(gt.node_q.numpy()[:12], gj.node_q[:12]).max() < 1e-4
    np.testing.assert_allclose(float(st.final_cost), float(sj.final_cost),
                               rtol=1e-4)
    # dead nodes keep their padding poses
    assert torch.equal(gt.node_t[12:], torch.zeros(8, 3))


# --- detection ---------------------------------------------------------------

def _random_ring(F=128, K=8, seed=3, revisit=(5, 0)):
    """tests/test_loop.py:87-115's ring: random descriptors, one slot a
    copy of another, as numpy fields over an empty map of each package."""
    rng = np.random.default_rng(seed)
    descs = rng.integers(0, 2, size=(K, F, 256)).astype(np.uint8)
    descs[revisit[0]] = descs[revisit[1]]
    return dict(kf_desc=descs, kf_kp_valid=np.ones((K, F), bool),
                kf_kp_xy=rng.uniform(10, 100, size=(K, F, 2)).astype(
                    np.float32),
                kf_kp_depth=np.full((K, F), 2.0, np.float32),
                kf_id=np.arange(K, dtype=np.int32), num_kf=np.int32(K))


def _maps(fields, cfg):
    from kbslam.mapping.state import empty_map as j_empty_map

    jm = j_empty_map(cfg.map, cfg.orb)._replace(
        **{k: jnp.asarray(v) for k, v in fields.items()})
    tm = t_empty_map(cfg.map, cfg.orb, "cpu")._replace(
        **{k: _t(v) for k, v in fields.items()})
    return jm, tm


def _ring_cfg(F=128):
    from kbslam.config import MapConfig, OrbConfig, PnPConfig, SLAMConfig

    return SLAMConfig(image_height=120, image_width=160,
                      orb=OrbConfig(num_features=F, num_levels=2,
                                    max_features=F),
                      pnp=PnPConfig(num_hypotheses=32),
                      map=MapConfig(max_keyframes=8, max_map_points=512))


def test_signatures_match_reference_exactly():
    fields = _random_ring()
    fields["kf_kp_valid"][2, ::3] = False    # some invalid keypoints
    sj = np.asarray(jdetect.kf_signatures(jnp.asarray(fields["kf_desc"]),
                                          jnp.asarray(fields["kf_kp_valid"])))
    st = tdetect.kf_signatures(_t(fields["kf_desc"]),
                               _t(fields["kf_kp_valid"])).numpy()
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(
        tdetect.word_ids(_t(fields["kf_desc"]), 10).numpy(),
        np.asarray(jdetect._word_ids(jnp.asarray(fields["kf_desc"]), 10)))
    np.testing.assert_allclose(st[5] @ st[0], 1.0, atol=1e-6)
    assert st[5] @ st[1] < 0.9


@pytest.mark.parametrize("query,sep,score_min", [
    (5, 3, 0.95), (5, 6, 0.95), (0, 3, 0.95), (3, 1, 0.0), (7, 2, 0.5)])
def test_detect_loop_matches_reference(query, sep, score_min):
    jm, tm = _maps(_random_ring(), _ring_cfg())
    cj = jdetect.detect_loop(jm, jnp.int32(query), min_separation=sep,
                             score_min=score_min)
    ct = tdetect.detect_loop(tm, torch.tensor(query, dtype=I32),
                             min_separation=sep, score_min=score_min)
    assert bool(ct.found) == bool(cj.found)
    assert int(ct.slot) == int(cj.slot)
    np.testing.assert_allclose(ct.scores.numpy(), np.asarray(cj.scores),
                               atol=1e-6)


# --- verification, closure and relocalization on a tracked map --------------

N_TRACK = 16
PROBE = dict(min_separation=2, score_min=0.3, min_inliers=20)


@pytest.fixture(scope="module")
def tracked():
    """The port's map after 16 frames of the 240x320 plane sequence (BA
    off, a keyframe every third frame), as numpy; each test builds both packages' states from it."""
    from kbslam.config import KeyframePolicyConfig

    seq = render_sequence(num_frames=N_TRACK, height=240, width=320)
    cfg = small_cfg().replace(policy=KeyframePolicyConfig(
        min_frame_gap=3, rotation_threshold_deg=2.0))
    slam = TSLAM(cfg, seq.K, ba_mode="disabled", use_mask=False,
                 device="cpu")
    for i in range(N_TRACK):
        slam.process(seq.rgb[i], seq.depth[i])
    assert slam.num_keyframes >= 4
    return seq, cfg, convert.to_numpy(slam.state)


def _states(np_state):
    ts = convert.to_torch(np_state, "cpu")
    js = JTrackState(
        map=JMapState(**{k: jnp.asarray(v)
                         for k, v in np_state.map._asdict().items()}),
        pose_q=jnp.asarray(np_state.pose_q), pose_t=jnp.asarray(np_state.pose_t),
        frames_since_kf=jnp.asarray(np_state.frames_since_kf),
        frame_count=jnp.asarray(np_state.frame_count))
    return js, ts


def _probe_both(seq, cfg, js, ts, qid):
    K = ts.map.capacity_kf
    num_kf = int(ts.map.num_kf)
    key = jax.random.fold_in(jax.random.PRNGKey(0x100B), num_kf)
    jprobe = jdetect.make_loop_probe(cfg, JIntr.from_matrix(seq.K), **PROBE)
    jc, jk = jprobe(js.map, jnp.int32((num_kf - 1) % K), jnp.int32(qid), key)
    tprobe = tdetect.make_loop_probe(cfg, TIntr.from_matrix(seq.K), **PROBE,
                                     sampler_for=lambda o: jax_sampler(key))
    tc, tk = tprobe(ts.map, torch.tensor((num_kf - 1) % K, dtype=I32),
                    torch.tensor(qid, dtype=I32),
                    torch.tensor(num_kf, dtype=I32))
    return jc, jk, tc, tk


def test_probe_matches_reference(tracked):
    seq, cfg, st = tracked
    js, ts = _states(st)
    num_kf = int(ts.map.num_kf)
    jc, jk, tc, tk = _probe_both(seq, cfg, js, ts, num_kf - 1)
    jc = convert.tuple_to_torch(jc, tdetect.LoopCandidate, "cpu")
    jk = convert.tuple_to_torch(jk, tdetect.LoopConstraint, "cpu")
    assert bool(tc.found) == bool(jc.found) and bool(tc.found)
    assert int(tc.slot) == int(jc.slot)
    torch.testing.assert_close(tc.scores, jc.scores, atol=1e-6, rtol=0)
    assert bool(tk.ok) == bool(jk.ok) and bool(tk.ok)
    assert int(tk.num_inliers) == int(jk.num_inliers) >= 20
    np.testing.assert_allclose(tk.rel_t.numpy(), np.asarray(jk.rel_t),
                               atol=1e-4)
    assert _rot_gap(tk.rel_q.numpy()[None], np.asarray(jk.rel_q)[None])[0] \
        < 1e-4
    # a stale query id (the slot no longer holds the expected keyframe)
    jc, jk, tc, tk = _probe_both(seq, cfg, js, ts, num_kf - 1 + 16)
    assert not bool(tc.found) and not bool(jc.found)
    assert not bool(tk.ok) and not bool(jk.ok)


@pytest.mark.parametrize("loop_ok", [True, False])
def test_close_loop_matches_reference(tracked, loop_ok):
    """A loop edge from the newest keyframe to the oldest, its measured
    pose the map's own moved by 5 cm and 2 deg, so the solve moves every
    keyframe and landmark."""
    seq, cfg, st = tracked
    js, ts = _states(st)
    m = ts.map
    num_kf = int(m.num_kf)
    si, sj = 0, (num_kf - 1) % m.capacity_kf
    rel = TSE3(m.kf_q[si], m.kf_t[si]).inverse().compose(
        TSE3(m.kf_q[sj], m.kf_t[sj]))
    nudge = TSE3.exp(torch.tensor([0.05, 0.0, 0.0, 0.0, np.radians(2.0), 0.0],
                                  dtype=torch.float32))
    rel = nudge.compose(rel).normalize()
    jm, jstats = jclosure.make_close_loop()(
        js.map, jnp.int32(si), jnp.int32(sj), jnp.asarray(rel.q.numpy()),
        jnp.asarray(rel.t.numpy()), jnp.bool_(loop_ok))
    tm, tstats = tclosure.make_close_loop()(
        m, torch.tensor(si, dtype=I32), torch.tensor(sj, dtype=I32), rel.q,
        rel.t, torch.tensor(loop_ok))
    for name in ("kf_t", "mp_pos"):
        np.testing.assert_allclose(getattr(tm, name).numpy(),
                                   np.asarray(getattr(jm, name)), atol=1e-4)
    assert _rot_gap(tm.kf_q.numpy(), jm.kf_q).max() < 1e-4
    np.testing.assert_allclose(float(tstats.final_cost),
                               float(jstats.final_cost), rtol=1e-3, atol=1e-9)
    moved = np.abs(tm.kf_t.numpy() - st.map.kf_t).max()
    if loop_ok:
        assert moved > 1e-3 and int(tstats.accepted) >= 1
    else:
        assert moved < 1e-5
        np.testing.assert_allclose(tm.mp_pos.numpy(), st.map.mp_pos,
                                   atol=1e-5)
    # functional write-back: the input map is untouched
    np.testing.assert_array_equal(m.kf_t.numpy(), st.map.kf_t)


@pytest.mark.parametrize("frame", [3, "blank"])
def test_reloc_step_matches_reference(tracked, frame):
    """The tracked map relocalizes an early frame of its own sequence (a
    revisit); a blank frame fails in both and leaves the map as it was."""
    seq, cfg, st = tracked
    js, ts = _states(st)
    rgb, dep = seq.rgb[0].copy(), seq.depth[0].copy()
    if frame == "blank":
        rgb[:], dep[:] = 0, 0
    else:
        rgb, dep = seq.rgb[frame], seq.depth[frame]
    kw = dict(word_bits=10, score_min=0.3, min_inliers=20)
    fc = int(ts.frame_count)
    key = jax.random.fold_in(jax.random.PRNGKey(0), fc + FRAME_OFFSET)
    jintr = JIntr.from_matrix(seq.K)
    jst, jr = jax.jit(lambda s, a, b, k: j_reloc_step(
        s, a, b, None, k, jintr, cfg, **kw))(js, jnp.asarray(rgb),
                                             jnp.asarray(dep), key)
    tstep = make_reloc_step(cfg, TIntr.from_matrix(seq.K), use_mask=False,
                            **kw, sampler_for_frame=lambda f: jax_sampler(
                                jax.random.fold_in(jax.random.PRNGKey(0),
                                                   f + FRAME_OFFSET)))
    tst, tr = tstep(ts, torch.from_numpy(rgb),
                    torch.from_numpy(dep.astype(np.int32)))
    assert bool(tr.success) == bool(jr.success)
    assert int(tst.map.num_kf) == int(jst.map.num_kf)
    np.testing.assert_array_equal(tst.map.kf_id.numpy(),
                                  np.asarray(jst.map.kf_id))
    if frame == "blank":
        assert not bool(tr.success)
        for name in ("kf_t", "kf_mp", "mp_pos", "num_mp"):
            np.testing.assert_array_equal(getattr(tst.map, name).numpy(),
                                          getattr(st.map, name))
        np.testing.assert_array_equal(tst.pose_t.numpy(), st.pose_t)
        return
    assert bool(tr.success) and int(tr.slot) == int(jr.slot)
    new = (int(tst.map.num_kf) - 1) % tst.map.capacity_kf
    assert np.linalg.norm(tst.map.kf_t[new].numpy()
                          - np.asarray(jst.map.kf_t[new])) < 0.01
    assert np.degrees(_rot_gap(tst.map.kf_q[new].numpy()[None],
                               np.asarray(jst.map.kf_q[new])[None])[0]) < 0.5
    np.testing.assert_allclose(tr.pose_t.numpy(), np.asarray(jr.pose_t),
                               atol=0.01)
    # it chains off the matched keyframe and lands near the frame's pose
    T0 = np.linalg.inv(seq.poses[0]) @ seq.poses[frame]
    est0 = TSE3(_t(st.map.kf_q[0]), _t(st.map.kf_t[0])).inverse().compose(
        TSE3(tr.pose_q, tr.pose_t)).t.numpy()
    assert np.linalg.norm(est0 - T0[:3, 3]) < 0.05


def test_reloc_skips_keyframes_inserted_while_lost(tracked):
    """A fault of the reference, not copied by the shells: a frame whose
    tracking failed may insert a keyframe at its held (wrong) pose, and
    the reference's relocalization then matches the frame against that
    keyframe (score 1) and re-anchors at the wrong pose. With
    ``exclude_from_id`` (the shells pass the insertion count of their
    last tracked frame) the port matches the keyframes inserted while
    tracking held, as on the map without the bogus keyframe."""
    from kbslam_torch.geom.camera import Intrinsics
    from kbslam_torch.mapping.state import insert_keyframe
    from kbslam_torch.pipeline import extract_frame

    seq, cfg, st = tracked
    frame = 4        # not itself a keyframe (they are frames 0, 3, 6, ...)
    rgb = torch.from_numpy(seq.rgb[frame])
    dep = torch.from_numpy(seq.depth[frame].astype(np.int32))
    intr = Intrinsics.from_matrix(seq.K)
    _, ts = _states(st)
    n0 = int(ts.map.num_kf)
    feats, depth_kp = extract_frame(rgb, dep, None, intr, cfg)
    held = TSE3(ts.pose_q, ts.pose_t + torch.tensor([1.0, 0.0, 0.0]))
    lost = convert.to_numpy(ts._replace(
        map=insert_keyframe(ts.map, feats, depth_kp, held)))
    kw = dict(word_bits=10, score_min=0.3, min_inliers=20)
    key = jax.random.fold_in(jax.random.PRNGKey(0),
                             int(st.frame_count) + FRAME_OFFSET)
    jintr = JIntr.from_matrix(seq.K)
    js, _ = _states(lost)
    _, jr = jax.jit(lambda s, a, b, k: j_reloc_step(
        s, a, b, None, k, jintr, cfg, **kw))(js, jnp.asarray(seq.rgb[frame]),
                                             jnp.asarray(seq.depth[frame]), key)
    assert bool(jr.success) and int(jr.slot) == n0 % 16   # the bogus one
    assert float(jr.score) > 0.999
    step = make_reloc_step(cfg, intr, use_mask=False, **kw)
    got = {}
    for name, exclude in (("lost", n0), ("clean", None)):
        state = convert.to_torch(lost if name == "lost" else st, "cpu")
        _, r = step(state, rgb, dep, exclude_from_id=exclude)
        got[name] = r
    assert bool(got["lost"].success)
    assert int(got["lost"].slot) == int(got["clean"].slot) != n0 % 16
    np.testing.assert_allclose(got["lost"].pose_t.numpy(),
                               got["clean"].pose_t.numpy(), atol=1e-4)


# --- the runner ----------------------------------------------------------------

class _RecordingProbe:
    """A probe that records the query ids it is given and never verifies."""

    def __init__(self):
        self.calls = []

    def __call__(self, m, qslot, qid, ordinal):
        self.calls.append((int(qslot), int(qid), int(ordinal)))
        cand = tdetect.LoopCandidate(found=torch.tensor(False),
                                     slot=torch.tensor(0, dtype=I32),
                                     score=torch.tensor(0.0),
                                     scores=torch.zeros(8))
        cons = tdetect.LoopConstraint(ok=torch.tensor(False),
                                      num_inliers=torch.tensor(0),
                                      rel_q=torch.zeros(4),
                                      rel_t=torch.zeros(3))
        return cand, cons


def _runner_state(cfg, num_kf=0):
    from kbslam_torch.pipeline import init_state

    st = init_state(cfg, "cpu")
    return st._replace(map=st.map._replace(
        num_kf=torch.tensor(num_kf, dtype=I32)))


def test_runner_pending_queue_defers_and_drains():
    """tests/test_loop.py:332-376 on the port's runner."""
    cfg = _ring_cfg()
    closer = TLoopCloser(cfg, TIntr.create(130.0, 130.0, 79.5, 59.5))
    probe = closer._probe = _RecordingProbe()
    st = _runner_state(cfg)
    closer.note_insertions(2)
    closer.tick(st, frame=10, ba_inflight=object())
    assert probe.calls == [] and closer._pending == [1, 2]
    closer.tick(st, frame=11, ba_inflight=None)
    assert [c[1] for c in probe.calls] == [0, 1] and closer._pending == []
    assert [c[2] for c in probe.calls] == [1, 2]
    closer.tick(st, frame=12, ba_inflight=None)
    assert len(probe.calls) == 2


def test_runner_stale_probe_is_self_invalidating():
    """tests/test_loop.py:379-419 on both packages' probes."""
    cfg = _ring_cfg(64)
    fields = _random_ring(F=64, seed=5)
    jm, tm = _maps(fields, cfg)
    intr = dict(fx=130.0, fy=130.0, cx=79.5, cy=59.5)
    kw = dict(min_separation=3, score_min=0.9, min_inliers=4)
    key = jax.random.PRNGKey(0)
    jprobe = jdetect.make_loop_probe(cfg, JIntr(**intr), **kw)
    tprobe = tdetect.make_loop_probe(cfg, TIntr.create(**intr), **kw,
                                     sampler_for=lambda o: jax_sampler(key))
    for qid, fresh in ((5, True), (13, False)):
        jc, jk = jprobe(jm, jnp.int32(5), jnp.int32(qid), key)
        tc, tk = tprobe(tm, torch.tensor(5, dtype=I32),
                        torch.tensor(qid, dtype=I32),
                        torch.tensor(1, dtype=I32))
        assert bool(tc.found) == bool(jc.found) == fresh
        assert bool(tk.ok) == bool(jk.ok)
        if fresh:
            assert int(tc.slot) == int(jc.slot) == 0
        else:
            assert not bool(tk.ok)


def test_resumed_runner_probes_the_newest_keyframe(tracked):
    """Fault of the reference: its runner numbers ordinals from 0, so
    after ``slam.state`` is replaced by a resumed state holding 20
    insertions (kbslam/cli.py:249-252) the next insertion probes
    keyframe id 0. The port's shell starts its runner at the map's
    num_kf and probes id 20."""
    from kbslam.pipeline import init_state as j_init
    from kbslam.slam import SLAM as JSLAM

    seq, cfg, _ = tracked
    cfg = cfg.replace(loop=cfg.loop.__class__(enabled=True))
    j = JSLAM(cfg, seq.K, ba_mode="disabled", use_mask=False)
    calls = []

    def j_probe(m, qslot, qid, key):
        calls.append(int(qid))
        return (jdetect.LoopCandidate(jnp.bool_(False), jnp.int32(0),
                                      jnp.float32(0), jnp.zeros(16)),
                jdetect.LoopConstraint(jnp.bool_(False), jnp.int32(0),
                                       jnp.zeros(4), jnp.zeros(3)))

    j._loop._probe = j_probe
    js = j_init(cfg)
    j.state = js._replace(map=js.map._replace(num_kf=jnp.int32(20)))
    j._loop.note_insertions()
    j._loop.tick(j.state, 0, None)
    assert calls == [0]                    # the reference's fault

    t = TSLAM(cfg, seq.K, ba_mode="disabled", use_mask=False, device="cpu")
    probe = t._loop._probe = _RecordingProbe()
    t.state = _runner_state(cfg, num_kf=20)     # a resume
    t._loop.note_insertions()
    t._loop.tick(t.state, 0, None)
    assert probe.calls == [(20 % 16, 20, 21)]


def test_chunked_reloc_insertion_reaches_the_runner(tracked):
    """Fault of the reference: kbslam/streaming.py:539-540 counts a
    relocalization insertion in ``_kf_seen`` but never tells the loop
    runner, whose ordinals then lag the map by one. The port's
    ChunkedStream reports it, so the next probe targets the inserted
    keyframe. Both relocalizations are made to succeed by a stand-in."""
    from kbslam.config import LoopConfig
    from kbslam.loop.reloc import RelocResult as JRelocResult
    from kbslam.pipeline import init_state as j_init
    from kbslam.streaming import ChunkedStream as JStream
    from kbslam_torch.loop.reloc import RelocResult as TRelocResult
    from kbslam_torch.streaming import ChunkedStream as TStream

    seq, cfg, st = tracked
    cfg = cfg.replace(loop=LoopConfig(enabled=True, reloc_after=2))
    js = JStream(cfg, JIntr.from_matrix(seq.K), j_init(cfg), chunk=4)
    ok = dict(success=True, slot=0, score=0.9, num_inliers=50)

    def j_reloc(state, rgb, dep):
        return state, JRelocResult(**{k: jnp.asarray(v) for k, v in
                                      ok.items()}, pose_q=state.pose_q,
                                   pose_t=state.pose_t)

    js._reloc = j_reloc
    js._fail_streak, js._frame = 2, 1
    js._frame_ring[0] = (seq.rgb[0], seq.depth[0], None)
    js._maybe_reloc()
    assert len(js.reloc_events) == 1 and js._kf_seen == 1
    assert js._loop._num_insertions == 0     # the reference's fault

    _, ts_state = _states(st)
    ts = TStream(cfg, TIntr.from_matrix(seq.K), ts_state, chunk=4)
    n0 = int(ts_state.map.num_kf)

    def t_reloc(state, rgb, dep, mask, exclude_from_id=None):
        return state, TRelocResult(
            **{k: torch.tensor(v) for k, v in ok.items()},
            pose_q=state.pose_q, pose_t=state.pose_t)

    ts._reloc = t_reloc
    ts._fail_streak = 2
    ts._probe_frame = (0, [seq.rgb[0], seq.depth[0].astype(np.int32)])
    ts._maybe_reloc()
    assert len(ts.reloc_events) == 1
    assert ts._loop._num_insertions == n0 + 1 and ts._loop._pending == [n0 + 1]
    # the same frame on the same map is not probed twice after a miss
    calls = []
    ts._reloc = lambda *a, **k: calls.append(1) or (a[0], TRelocResult(
        **{k: torch.tensor(v) for k, v in dict(ok, success=False).items()},
        pose_q=a[0].pose_q, pose_t=a[0].pose_t))
    ts._fail_streak = 2
    ts._maybe_reloc()
    ts._maybe_reloc()
    assert calls == [1]


# --- lost-and-found on the port's shells ------------------------------------

def _pan(T):
    from scipy.spatial.transform import Rotation

    poses = []
    for i in range(T):
        s = i / max(T - 1, 1)
        P = np.eye(4)
        P[:3, :3] = Rotation.from_rotvec([0, 0.55 * s, 0]).as_matrix()
        P[:3, 3] = [2.2 * s, 0.0, -2.5]
        poses.append(P)
    return np.stack(poses)


def lost_and_found(T_back, T_sweep=22, T_blank=3, height=240, width=320):
    """tests/test_loop.py:277-295: pan away, blank frames, pan back."""
    poses = np.concatenate([_pan(T_sweep), _pan(T_sweep)[:T_blank],
                            _pan(T_sweep)[:T_back]])
    seq = render_sequence(num_frames=len(poses), height=height, width=width,
                          fx=260.0 * width / 320, scene="spheres", seed=2,
                          poses=poses)
    rgb, dep = seq.rgb.copy(), seq.depth.copy()
    rgb[T_sweep:T_sweep + T_blank] = 0
    dep[T_sweep:T_sweep + T_blank] = 0
    return seq, rgb, dep, poses


def lost_cfg(reloc_after, height=240, width=320, orb=None):
    """tests/test_loop.py:298-306's configuration (the port's config)."""
    from kbslam_torch import config as C

    return C.SLAMConfig(
        image_height=height, image_width=width,
        orb=orb or C.OrbConfig(num_features=512, num_levels=4,
                               max_features=512),
        pnp=C.PnPConfig(num_hypotheses=128),
        policy=C.KeyframePolicyConfig(min_frame_gap=4),
        map=C.MapConfig(max_keyframes=16, max_map_points=8192),
        loop=C.LoopConfig(reloc_after=reloc_after, reloc_score_min=0.4,
                          reloc_min_inliers=30))


def tail_errors(est, poses, frames):
    """Gauge-relative position errors (both trajectories anchor frame 0)."""
    T0_gt, T0_est = np.linalg.inv(poses[0]), np.linalg.inv(est[0])
    return np.array([np.linalg.norm((T0_est @ est[i])[:3, 3]
                                    - (T0_gt @ poses[i])[:3, 3])
                     for i in frames])


def test_relocalization_recovers_after_tracking_loss():
    """tests/test_loop.py:264-329's gates on the port's SLAM."""
    seq, rgb, dep, poses = lost_and_found(T_back=8)
    errs, shells = {}, {}
    for reloc_after in (0, 2):
        s = TSLAM(lost_cfg(reloc_after), seq.K, ba_mode="on_keyframe",
                  use_mask=False, device="cpu")
        for i in range(len(poses)):
            s.process(rgb[i], dep[i])
        errs[reloc_after] = tail_errors(s.frame_poses, poses,
                                        range(25, len(poses)))
        shells[reloc_after] = s
    s = shells[2]
    assert len(s.reloc_events) >= 1, "relocalization never fired"
    ev = s.reloc_events[0]
    assert ev["inliers"] >= 30 and ev["score"] >= 0.4, ev
    assert all(d["success"] for d in s.diagnostics[26:])
    assert errs[2].max() < 0.08, errs[2]
    assert errs[0].max() > 0.3, errs[0]


def test_chunked_relocalization_recovers_after_tracking_loss():
    """tests/test_loop.py:422-494's gates on the port's ChunkedStream
    (chunk 4): the probe fires chunk-late and tracking is back within one
    chunk of it, the tail within 8 cm."""
    from kbslam_torch.pipeline import init_state
    from kbslam_torch.slam import pose_T
    from kbslam_torch.streaming import ChunkedStream

    seq, rgb, dep, poses = lost_and_found(T_back=11)
    C = 4
    cfg = lost_cfg(2)
    cs = ChunkedStream(cfg, TIntr.from_matrix(seq.K), init_state(cfg, "cpu"),
                       chunk=C)
    results = []
    for i in range(len(poses)):
        results += cs.feed(rgb[i], dep[i])
    results += cs.flush()
    assert len(results) == len(poses)
    assert len(cs.reloc_events) >= 1, "chunk-late reloc never fired"
    ev = cs.reloc_events[0]
    assert ev["inliers"] >= 30 and ev["score"] >= 0.4, ev
    recover_by = ev["frame"] + 2 * C
    tail = [r for r in results if r["frame"] >= recover_by]
    assert tail and all(r["success"] for r in tail)
    est = [pose_T(r["pose_q"], r["pose_t"]) for r in results]
    assert tail_errors(est, poses, range(recover_by, len(poses))).max() < 0.08
