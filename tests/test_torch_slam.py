"""The port's SLAM shell with local BA against the JAX reference.

- ``ba_mode="on_keyframe"`` (the default of both) on the 20-frame
  240x320 sequence of tests/test_torch_pipeline.py, the port's RANSAC
  given the minimal sets the reference draws from its per-frame keys:
  the same success, keyframe and BA decisions on every frame, and every
  frame pose and every refined pose within 1 cm of the reference's.
- ``ba_mode="async"`` on the CPU (the solve runs at dispatch and merges
  at the next poll): the gates of tests/test_async_ba.py:28-39.
- The hard scene of tests/test_ba_in_loop.py (spheres, 2 mm depth noise,
  2% dropout, ``track_keyframes=3``) at seed 0, BA on, with the
  reference's minimal sets: the port's online and refined ATE each
  within 5 mm of the reference's, and that test's absolute gates.
"""
import jax
import numpy as np
import pytest
import torch

from kbslam.eval.trajectory import ate_rmse
from kbslam.io.synthetic import render_sequence
from kbslam.slam import SLAM as JSLAM
from kbslam_torch.geom.camera import Intrinsics as TIntr
from kbslam_torch.pipeline import make_track_step as t_make
from kbslam_torch.slam import SLAM as TSLAM
from test_ba_in_loop import _cfg as hard_cfg
from test_async_ba import cfg240
from test_pipeline import small_cfg
from test_torch_pipeline import jax_sampler

torch.set_num_threads(1)


def _jax_keyed_sampler(frame_count):
    """The sets kbslam.slam.SLAM's step draws (seed 0, auto_key)."""
    return jax_sampler(jax.random.fold_in(jax.random.PRNGKey(0), frame_count))


def _run(seq, cfg, mode):
    """(JAX SLAM, port SLAM) after tracking ``seq`` with BA ``mode``."""
    j = JSLAM(cfg, seq.K, ba_mode=mode, use_mask=False)
    t = TSLAM(cfg, seq.K, ba_mode=mode, use_mask=False, device="cpu")
    # the port's tracking step with the reference's minimal sets
    t._step = t_make(cfg, TIntr.from_matrix(seq.K), use_mask=False,
                     sampler_for_frame=_jax_keyed_sampler)
    for s in (j, t):
        for i in range(len(seq.rgb)):
            s.process(seq.rgb[i], seq.depth[i])
    return j, t


def _ate(poses, seq):
    return ate_rmse(np.stack(poses)[:, :3, 3], seq.poses[:, :3, 3])


def test_on_keyframe_matches_reference():
    seq = render_sequence(num_frames=20, height=240, width=320)
    j, t = _run(seq, small_cfg(), "on_keyframe")
    keys = ("success", "added_kf", "ran_ba")
    assert ([[d[k] for k in keys] for d in t.diagnostics]
            == [[d[k] for k in keys] for d in j.diagnostics])
    assert len(t.ba_stats) == len(j.ba_stats) >= 2
    for a, b in zip(t.ba_stats, j.ba_stats):
        assert a["num_pruned"] == b["num_pruned"]
        assert a["final_cost"] <= a["initial_cost"] * 1.001
    gaps = [np.linalg.norm(a[:3, 3] - b[:3, 3])
            for a, b in zip(t.frame_poses, j.frame_poses)]
    assert max(gaps) < 0.01, gaps
    tr, jr = t.refined_trajectory(), j.refined_trajectory()
    assert tr.shape == jr.shape == (20, 4, 4)
    assert np.abs(tr[:, :3, 3] - jr[:, :3, 3]).max() < 0.01
    assert [a for a, _ in t.frame_anchors] == [a for a, _ in j.frame_anchors]
    np.testing.assert_allclose(t.keyframe_positions(), j.keyframe_positions(),
                               atol=0.01)
    assert t.map_points().shape == j.map_points().shape


def test_async_on_cpu():
    seq = render_sequence(num_frames=40, height=240, width=320)
    slam = TSLAM(cfg240(), seq.K, ba_mode="async", use_mask=False,
                 device="cpu")
    for i in range(40):
        slam.process(seq.rgb[i], seq.depth[i])
    slam.finish()
    assert len(slam.ba_stats) >= 1
    assert sum(d["ran_ba"] for d in slam.diagnostics) >= 1
    assert _ate(slam.frame_poses, seq) < 0.05
    for s in slam.ba_stats:
        assert s["final_cost"] <= s["initial_cost"] * 1.001


@pytest.mark.parametrize("seed", [0])
def test_hard_scene_nk3_matches_reference(seed):
    seq = render_sequence(num_frames=40, height=240, width=320,
                          scene="spheres", depth_noise_mm=2.0,
                          depth_dropout=0.02, seed=seed)
    j, t = _run(seq, hard_cfg(), "on_keyframe")
    ate_j, ate_t = _ate(j.frame_poses, seq), _ate(t.frame_poses, seq)
    ref_j = _ate(list(j.refined_trajectory()), seq)
    ref_t = _ate(list(t.refined_trajectory()), seq)
    assert abs(ate_t - ate_j) < 0.005, (ate_t, ate_j)
    assert abs(ref_t - ref_j) < 0.005, (ref_t, ref_j)
    assert sum(d["success"] for d in t.diagnostics) >= 36
    assert len(t.ba_stats) >= 2
    assert ate_t < 0.09 and ref_t < 0.05 and ref_t <= ate_t + 1e-3, (
        ate_t, ref_t)


def _order_cfg():
    """test_streaming's 160x120 configuration (the port's copy) with
    culling, loop closure and relocalization after one failure on."""
    import dataclasses

    from kbslam_torch import config as tconfig

    cfg = tconfig.SLAMConfig(
        image_height=120, image_width=160,
        orb=tconfig.OrbConfig(num_features=256, num_levels=3,
                              max_features=256),
        pnp=tconfig.PnPConfig(num_hypotheses=64),
        policy=tconfig.KeyframePolicyConfig(min_frame_gap=3),
        map=tconfig.MapConfig(max_keyframes=8, max_map_points=4096))
    return cfg.replace(
        cull=dataclasses.replace(cfg.cull, enabled=True),
        loop=dataclasses.replace(cfg.loop, enabled=True, reloc_after=1))


STAGES = ["cull", "merge", "reloc", "loop", "dispatch"]


def _record(log, shell, clock):
    """Wrap the shell's cull, merge, reloc, loop tick and BA dispatch so
    each call appends (stage, clock()) to ``log``."""
    def wrap(name, fn):
        def inner(*a, **k):
            log.append((name, clock()))
            return fn(*a, **k)
        return inner

    shell._cull = wrap("cull", shell._cull)
    shell._reloc = wrap("reloc", shell._reloc)
    shell._loop.tick = wrap("loop", shell._loop.tick)
    shell._async.merge = wrap("merge", shell._async.merge)
    shell._async.dispatch = wrap("dispatch", shell._async.dispatch)


def _in_order(log):
    """Per clock tick, the stages run in the reference's order."""
    by_tick = {}
    for name, tick in log:
        by_tick.setdefault(tick, []).append(STAGES.index(name))
    return all(v == sorted(v) for v in by_tick.values())


def test_process_runs_cull_ba_reloc_loop_dispatch_in_order():
    """kbslam/slam.py:255-354's order inside process: cull on insertion,
    the merge of a finished solve, the relocalization tick, the loop tick
    (its probes deferred while a solve is in flight), the new dispatch
    last; finish() merges the last solve, then drains the loop queue.
    A blank frame makes tracking fail, so relocalization runs."""
    seq = render_sequence(num_frames=14, height=120, width=160,
                          fx=525.0 * 160 / 640.0)
    slam = TSLAM(_order_cfg(), seq.K, ba_mode="async", use_mask=False,
                 device="cpu")
    log = []
    _record(log, slam, lambda: slam._frame)
    for i in range(14):
        rgb, dep = seq.rgb[i], seq.depth[i]
        if i == 10:
            rgb, dep = np.zeros_like(rgb), np.zeros_like(dep)
        slam.process(rgb, dep)
    names = {n for n, _ in log}
    assert names == set(STAGES), names
    assert _in_order(log), log
    assert ("reloc", 10) in log
    inserted = sum(d["added_kf"] for d in slam.diagnostics)
    assert len([1 for n, _ in log if n == "cull"]) == inserted
    assert slam._async.inflight is not None      # the last dispatch
    slam.finish()
    assert [n for n, _ in log[-2:]] == ["merge", "loop"]
    assert slam._async.inflight is None and slam._loop._pending == []
    assert slam._loop._num_insertions == slam.num_keyframes
