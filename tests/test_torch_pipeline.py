"""The port's tracking step as a whole against the JAX reference.

Both pipelines track the same 20-frame 240x320 synthetic sequence with
``test_pipeline.small_cfg``; the port's RANSAC is given the minimal sets
the reference draws from its per-frame keys, so the two differ only by
float32 rounding (the pyramid, Harris and the solvers sum in another
order). Bounds: the same keyframe and success decisions on every frame;
per-frame pose within 1 cm and 0.5 deg; ATE within 5 mm of the
reference's.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbslam.eval.trajectory import ate_rmse
from kbslam.geom.camera import Intrinsics as JIntr
from kbslam.io.synthetic import render_sequence
from kbslam.mapping.state import MapState as JMapState
from kbslam.pipeline import TrackState as JTrackState
from kbslam.pipeline import init_state as j_init, make_track_step as j_make
from kbslam.pnp import ransac as jransac
from kbslam_torch import convert
from kbslam_torch.geom.camera import Intrinsics as TIntr
from kbslam_torch.pipeline import init_state as t_init, make_track_step as t_make
from kbslam_torch.slam import pose_T
from test_pipeline import small_cfg

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
N = 20
RESUME_AT = 10


def jax_sampler(key):
    """The index sets kbslam.pnp.ransac draws from ``key``."""
    def sample(valid, pool, k_dlt, k_kabsch, set_size, packed):
        key_a, key_b = jax.random.split(key)
        idx_d = jransac._sample_valid_indices(
            key_a, jnp.asarray(valid.numpy()), k_dlt, set_size, packed=packed)
        idx_k = None if pool is None else jransac._sample_valid_indices(
            key_b, jnp.asarray(pool.numpy()), k_kabsch, set_size)
        return (torch.from_numpy(np.array(idx_d)),
                None if idx_k is None else torch.from_numpy(np.array(idx_k)))
    return sample


def _jax_sampler_for_frame(frame_count):
    return jax_sampler(jax.random.PRNGKey(frame_count))


def _out(o):
    return dict(T=pose_T(np.asarray(o.pose_q), np.asarray(o.pose_t)),
                success=bool(o.success), added_kf=bool(o.added_kf),
                num_inliers=int(o.num_inliers))


def _run_torch(step, state, seq, frames):
    outs = []
    for i in frames:
        state, o = step(state, torch.from_numpy(seq.rgb[i]),
                        torch.from_numpy(seq.depth[i].astype(np.int32)))
        outs.append(_out(o))
    return outs, state


@pytest.fixture(scope="module")
def runs():
    seq = render_sequence(num_frames=N, height=240, width=320)
    cfg = small_cfg()
    jstep = j_make(cfg, JIntr.from_matrix(seq.K), use_mask=False)
    state = j_init(cfg)
    jouts, resume_state = [], None
    for i in range(N):
        if i == RESUME_AT:
            resume_state = jax.device_get(state)
        state, o = jstep(state, jnp.asarray(seq.rgb[i]),
                         jnp.asarray(seq.depth[i]), jax.random.PRNGKey(i))
        jouts.append(_out(jax.device_get(o)))
    tstep = t_make(cfg, TIntr.from_matrix(seq.K), use_mask=False,
                   sampler_for_frame=_jax_sampler_for_frame)
    touts, _ = _run_torch(tstep, t_init(cfg, "cpu"), seq, range(N))
    return dict(seq=seq, cfg=cfg, jstep=jstep, tstep=tstep, jouts=jouts,
                touts=touts, resume_state=resume_state)


def _pose_gap(Ta, Tb):
    dt = np.linalg.norm(Ta[:3, 3] - Tb[:3, 3])
    c = np.clip((np.trace(Ta[:3, :3].T @ Tb[:3, :3]) - 1) / 2, -1, 1)
    return dt, np.degrees(np.arccos(c))


def _compare(touts, jouts):
    assert [o["added_kf"] for o in touts] == [o["added_kf"] for o in jouts]
    assert [o["success"] for o in touts] == [o["success"] for o in jouts]
    for i, (a, b) in enumerate(zip(touts, jouts)):
        dt, dr = _pose_gap(a["T"], b["T"])
        assert dt < 0.01 and dr < 0.5, (i, dt, dr)


def test_decisions_and_poses_match(runs):
    assert all(o["success"] for o in runs["jouts"][1:])
    assert sum(o["added_kf"] for o in runs["jouts"]) >= 2
    _compare(runs["touts"], runs["jouts"])


def test_ate_matches(runs):
    gt = runs["seq"].poses[:, :3, 3]
    ate_j = ate_rmse(np.stack([o["T"] for o in runs["jouts"]])[:, :3, 3], gt)
    ate_t = ate_rmse(np.stack([o["T"] for o in runs["touts"]])[:, :3, 3], gt)
    assert ate_j < 0.05
    assert abs(ate_t - ate_j) < 0.005, (ate_t, ate_j)


def test_convert_round_trip_resumes_mid_sequence(runs):
    """The reference's state after frame 9 goes into the port, which
    tracks frames 10-19 as the reference did; converted back, it is the
    same state bit for bit and the reference resumes from it exactly."""
    seq, js = runs["seq"], runs["resume_state"]
    tstate = convert.to_torch(js, "cpu")
    back = convert.to_numpy(tstate)
    for name in JMapState._fields:
        np.testing.assert_array_equal(getattr(back.map, name),
                                      np.asarray(getattr(js.map, name)))
    rebuilt = JTrackState(
        map=JMapState(**{k: jnp.asarray(v) for k, v in back.map._asdict().items()}),
        pose_q=jnp.asarray(back.pose_q), pose_t=jnp.asarray(back.pose_t),
        frames_since_kf=jnp.asarray(back.frames_since_kf),
        frame_count=jnp.asarray(back.frame_count))
    _, o = runs["jstep"](rebuilt, jnp.asarray(seq.rgb[RESUME_AT]),
                         jnp.asarray(seq.depth[RESUME_AT]),
                         jax.random.PRNGKey(RESUME_AT))
    np.testing.assert_array_equal(_out(jax.device_get(o))["T"],
                                  runs["jouts"][RESUME_AT]["T"])
    touts, _ = _run_torch(runs["tstep"], tstate, seq, range(RESUME_AT, N))
    _compare(touts, runs["jouts"][RESUME_AT:])


def test_nk3_bank_matches(runs):
    """track_keyframes=3: the frame is matched against a bank of the last
    three keyframes in the world frame. Same bounds as the NK=1 run."""
    seq = runs["seq"]
    cfg = runs["cfg"].replace(track_keyframes=3)
    jstep = j_make(cfg, JIntr.from_matrix(seq.K), use_mask=False)
    state, jouts = j_init(cfg), []
    for i in range(N):
        state, o = jstep(state, jnp.asarray(seq.rgb[i]),
                         jnp.asarray(seq.depth[i]), jax.random.PRNGKey(i))
        jouts.append(_out(jax.device_get(o)))
    tstep = t_make(cfg, TIntr.from_matrix(seq.K), use_mask=False,
                   sampler_for_frame=_jax_sampler_for_frame)
    touts, tstate = _run_torch(tstep, t_init(cfg, "cpu"), seq, range(N))
    assert all(o["success"] for o in jouts[1:])
    assert int(tstate.map.num_kf) >= 2
    _compare(touts, jouts)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _cli(*args):
    r = subprocess.run(
        [sys.executable, "-m", "kbslam_torch.cli", "--source", "synthetic",
         "--frames", "8", "--width", "160", "--height", "120", "--eval",
         "--device", "cpu", *args],
        capture_output=True, text=True, cwd=REPO, env=_env(), timeout=300)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_cli_smoke():
    """--ba off runs no solve; --ba on (the default) solves after each
    keyframe and reports the refined trajectory's ATE."""
    keys = {"frames", "success", "keyframes", "ba_runs", "mean_track_ms",
            "ate_rmse_m", "rpe_trans_m", "rpe_rot_rad"}
    off = _cli("--ba", "off")
    assert set(off) == keys
    assert off["frames"] == 8 and off["ba_runs"] == 0
    on = _cli()
    assert set(on) == keys | {"ate_rmse_refined_m"}
    assert on["frames"] == 8 and on["ba_runs"] >= 1


def test_port_imports_no_jax():
    """Neither JAX nor the kbslam package by name, and no module loaded
    from a file under kbslam/ under any name."""
    code = ("import sys, os, kbslam_torch, kbslam_torch.pipeline, "
            "kbslam_torch.cli, kbslam_torch.slam, kbslam_torch.convert, "
            "kbslam_torch.ops.describe, "
            "kbslam_torch.ba.local_ba, kbslam_torch.ba.lm, "
            "kbslam_torch.ba.merge, "
            "kbslam_torch.streaming, kbslam_torch.io.checkpoint, "
            "kbslam_torch.io.tum, kbslam_torch.io.native_loader, "
            "kbslam_torch.loop.pose_graph, kbslam_torch.loop.closure, "
            "kbslam_torch.loop.detect, kbslam_torch.loop.runner, "
            "kbslam_torch.loop.reloc, kbslam_torch.mapping.cull, "
            "kbslam_torch.mapping.submap, kbslam_torch.mapping.icp, "
            "kbslam_torch.ba.global_ba, kbslam_torch.parallel.multistream, "
            "kbslam_torch.parallel.dist, "
            "kbslam_torch.io.zmq_camera, kbslam_torch.io.proto.as_camera_pb2, "
            "kbslam_torch.viz.rerun_viewer, kbslam_torch.utils.profiling, "
            "kbslam_torch.utils.logging; "
            "bad = [m for m in sys.modules if m == 'jax' or m == 'kbslam' "
            "or m.startswith(('jax.', 'kbslam.'))]; "
            "ref = os.path.join(os.getcwd(), 'kbslam') + os.sep; "
            "bad += [m for m, mod in list(sys.modules.items()) "
            "if (getattr(mod, '__file__', None) or '').startswith(ref)]; "
            "assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, env=_env(), timeout=120)
    assert r.returncode == 0, r.stderr
