"""The port's global bundle adjustment (kbslam_torch/ba/global_ba.py)
against the JAX reference on its synthetic problems, solved on one
device (JAX on a mesh of ``jax.devices()[:1]``), and the reference's own
gates (tests/test_global_ba.py) on the port's numbers.

Bounds, JAX's problem carried over by ``convert``:
- ``global_ba_step``, 3 steps of 3 PCG trips (seeds 0, 2): after each,
  poses within 1e-5 m and 1e-4 deg, landmarks within 1e-5 m, the costs
  within 1e-4 relative. Few trips keep the costs far above the float32
  floor of the problem: two full steps converge it to ~1e-8 of its
  start, where rounding in the iterates sets every digit;
- ``global_ba_solve`` with ``pcg_tol=0`` (4 rounds of 3 trips): every
  round's cost within 1e-4 relative, ``accepted`` and ``retries``
  equal; with the default tol (3 rounds, cap 30): PCG trips within +-1
  per round where the stop is live, ``accepted`` and ``retries`` equal,
  the final cost within 1e-3 relative or 1e-6 of the start (the last
  round converges to ~2e-8 of its start, where the cost is rounding);
  each with the depth rows on and off.

From a tracked map (tests/test_global_ba_from_map.py's configuration,
24 of its 40 frames: 3 keyframes, tracked once by JAX's ``SLAM`` and
carried over by ``convert.map_to_torch``): ``from_map_state`` equal to
JAX's (ints and masks exactly, floats within 1e-6); 4 guarded rounds and
``run_global_ba_on_map`` with costs within 1e-4 relative, equal
``accepted``, ``retries`` and PCG trips, keyframes and landmarks within
1e-5 m; the oldest real keyframe bit-unchanged by ``write_back``; and
the depth-rows gate of tests/test_global_ba_from_map.py:59-104 on the
port's numbers.

The reference's multi-device cases (``test_global_ba_matches_single_device``,
``test_landmark_sharded_solve_matches_replicated``,
``test_dryrun_multichip_contract``) run over gloo process groups in
tests/test_torch_distributed.py.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from kbslam.ba import global_ba as jgba
from kbslam.config import MapConfig, OrbConfig, PnPConfig, SLAMConfig
from kbslam.io.synthetic import render_sequence
from kbslam.slam import SLAM as JSLAM
from kbslam.slam import run_global_ba_on_map as j_run_global_ba
from kbslam_torch import convert
from kbslam_torch.ba import global_ba as tgba
from kbslam_torch.eval.trajectory import ate_rmse
from kbslam_torch.geom.camera import Intrinsics as TIntr
from kbslam_torch.slam import run_global_ba_on_map as t_run_global_ba
from kbslam_torch.geom.se3 import quat_conj, quat_mul

torch.set_num_threads(1)
MESH1 = Mesh(np.array(jax.devices()[:1]), axis_names=("stream",))


def _problem(seed, n_pts=64, noise=0.005):
    data, intr, gt = jgba.make_synthetic_global_problem(
        np.random.default_rng(seed), n_cams=8, n_pts=n_pts, noise=noise)
    return (data, convert.global_ba_data_to_torch(jax.device_get(data), "cpu"),
            intr, TIntr.create(intr.fx, intr.fy, intr.cx, intr.cy), gt)


def _angle_deg(qa, qb):
    """Largest rotation angle between two sets of unit quaternions."""
    d = quat_mul(quat_conj(qa.double()), qb.double())
    v = torch.linalg.vector_norm(d[..., 1:], dim=-1)
    return float(torch.rad2deg(2 * torch.atan2(v, d[..., 0].abs())).max())


def _close(t, j, pos_m, deg):
    j = convert.global_ba_data_to_torch(jax.device_get(j), "cpu")
    assert float((t.cam_t - j.cam_t).abs().max()) < pos_m
    assert _angle_deg(t.cam_q, j.cam_q) < deg
    assert float((t.mp_pos - j.mp_pos).abs().max()) < pos_m


def test_synthetic_problem_matches_reference():
    """The port's builder draws the same problem from the same rng."""
    data, _, _ = tgba.make_synthetic_global_problem(
        np.random.default_rng(0), "cpu")
    jdata, tdata, *_ = _problem(0)
    for name, a, b in zip(tgba.GlobalBAData._fields, data, tdata):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7,
                                   err_msg=name)


@pytest.mark.parametrize("seed", [0, 2])
def test_global_ba_step_matches_reference(seed):
    jd, td, jintr, tintr, _ = _problem(seed)
    for _ in range(3):
        jd, jc = jgba.global_ba_step(jd, jintr, MESH1, pcg_iters=3,
                                     damping=1e-4)
        td, tc = tgba.global_ba_step(td, tintr, pcg_iters=3, damping=1e-4)
        np.testing.assert_allclose(float(tc), float(jc), rtol=1e-4)
        _close(td, jd, 1e-5, 1e-4)


@pytest.mark.parametrize("depth_rows", [False, True])
@pytest.mark.parametrize("seed", [0, 2])
def test_global_ba_solve_matches_reference(seed, depth_rows):
    jd, td, jintr, tintr, _ = _problem(seed)
    # every trip live: the iterates and costs at fixed trip counts
    _, jc, js = jgba.global_ba_solve(jd, jintr, MESH1, iters=4, pcg_iters=3,
                                     pcg_tol=0.0, depth_rows=depth_rows,
                                     return_stats=True)
    _, tc, ts = tgba.global_ba_solve(td, tintr, iters=4, pcg_iters=3,
                                     pcg_tol=0.0, depth_rows=depth_rows,
                                     return_stats=True)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4)
    np.testing.assert_array_equal(ts.accepted.numpy(), np.asarray(js.accepted))
    np.testing.assert_array_equal(ts.retries.numpy(), np.asarray(js.retries))
    np.testing.assert_array_equal(ts.pcg_iters.numpy(), [3, 3, 3, 3])

    # the default early stop
    _, jc, js = jgba.global_ba_solve(jd, jintr, MESH1, iters=3,
                                     depth_rows=depth_rows, return_stats=True)
    _, tc, ts = tgba.global_ba_solve(td, tintr, iters=3,
                                     depth_rows=depth_rows, return_stats=True)
    np.testing.assert_array_equal(ts.accepted.numpy(), np.asarray(js.accepted))
    np.testing.assert_array_equal(ts.retries.numpy(), np.asarray(js.retries))
    assert (np.abs(ts.pcg_iters.numpy() - np.asarray(js.pcg_iters))
            <= 1).all(), (ts.pcg_iters, js.pcg_iters)
    jc = np.asarray(jc)
    np.testing.assert_allclose(float(tc[-1]), jc[-1], rtol=1e-3,
                               atol=1e-6 * jc[0])


# --- the reference's gates on the port's numbers --------------------------

def test_global_ba_converges():
    _, data, _, intr, gt = _problem(0)
    costs = []
    for _ in range(6):
        data, cost = tgba.global_ba_step(data, intr, pcg_iters=25,
                                         damping=1e-6)
        costs.append(float(cost))
    _, final = tgba.global_ba_step(data, intr, pcg_iters=1, damping=1e-6)
    assert float(final) < 1e-3 * costs[0]
    err = np.linalg.norm(data.mp_pos[:64].numpy() - gt["pts"], axis=1)
    assert np.median(err) < 1e-2


def test_gauge_fixed_camera_unchanged():
    _, data, _, intr, _ = _problem(2)
    out, _ = tgba.global_ba_step(data, intr, pcg_iters=10)
    assert torch.equal(out.cam_q[0], data.cam_q[0])
    assert torch.equal(out.cam_t[0], data.cam_t[0])


def _cost(d, intr):
    return float(tgba._robust_cost(d.cam_q, d.cam_t, d.mp_pos, d, intr,
                                   False, 1.0))


def _monotone(g):
    assert np.all(np.isfinite(g))
    assert np.all(np.diff(g) <= 1e-4 * g[:-1] + 1e-6)


def test_lm_guard_rejects_divergent_steps():
    """A badly initialised problem: the unguarded step does not descend,
    the guarded solve stays finite, non-increasing and below its start,
    rejecting damping levels on the way.

    The step's system is indefinite here, so float32 rounding decides
    where it goes: after one PCG trip both packages land ~0.4 m from a
    float64 solve. JAX's 30 trips end finite at a higher cost, the
    port's PCG breaks down at trip 7 (NaN); either way the step does
    not descend, which is the reference's point (its docstring: "and
    eventually NaNs")."""
    _, data, _, intr, _ = _problem(2, noise=1.0)
    d1, _ = tgba.global_ba_step(data, intr, pcg_iters=30, damping=1e-4)
    assert not _cost(d1, intr) <= _cost(data, intr)
    _, costs, stats = tgba.global_ba_solve(data, intr, iters=8, pcg_iters=30,
                                           return_stats=True)
    g = costs.numpy()
    _monotone(g)
    assert g[-1] <= g[0]
    assert stats.retries.max() > 1


def test_lm_guard_converges_with_rejections():
    _, data, _, intr, _ = _problem(0, noise=0.5)
    _, costs = tgba.global_ba_solve(data, intr, iters=12, pcg_iters=30)
    g = costs.numpy()
    _monotone(g)
    assert g[-1] < 1e-2 * g[0], g


def test_pcg_early_stop_bounds_iterations():
    """PCG stops far below a cap of 100 on an easy problem, and the masked
    trips after the stop change nothing."""
    _, data, _, intr, _ = _problem(4, n_pts=48)
    d, costs, stats = tgba.global_ba_solve(data, intr, iters=4,
                                           pcg_iters=100, pcg_tol=1e-2,
                                           return_stats=True)
    used, rets = stats.pcg_iters.numpy(), stats.retries.numpy()
    assert (used <= 100 * rets).all()
    assert used[0] < 100, used
    assert float(costs[-1]) < 1e-2 * float(costs[0])
    # the same solve with the cap at the trips it used: the same result
    d2, costs2 = tgba.global_ba_solve(data, intr, iters=1,
                                      pcg_iters=int(used[0]), pcg_tol=1e-2)
    d1, costs1 = tgba.global_ba_solve(data, intr, iters=1, pcg_iters=100,
                                      pcg_tol=1e-2)
    assert torch.equal(costs1, costs2) and torch.equal(d1.cam_t, d2.cam_t)


# --- over a map that JAX's SLAM tracked ---------------------------------------

MAP_FRAMES = 24


@pytest.fixture(scope="module")
def tracked():
    seq = render_sequence(num_frames=MAP_FRAMES, height=240, width=320)
    cfg = SLAMConfig(
        image_height=240, image_width=320,
        orb=OrbConfig(num_features=512, num_levels=4, max_features=512),
        pnp=PnPConfig(num_hypotheses=128),
        map=MapConfig(max_keyframes=16, max_map_points=8192))
    slam = JSLAM(cfg, seq.K, ba_mode="disabled", use_mask=False)
    for i in range(MAP_FRAMES):
        slam.process(seq.rgb[i], seq.depth[i])
    assert int(slam.state.map.num_kf) >= 3
    kf_frames = [d["frame"] for d in slam.diagnostics if d["added_kf"]]
    return dict(cfg=cfg, jmap=slam.state.map, jintr=slam.intr,
                tmap=convert.map_to_torch(jax.device_get(slam.state.map),
                                          "cpu"),
                tintr=TIntr.from_matrix(seq.K),
                gt_kf=seq.poses[kf_frames][:, :3, 3])


@pytest.mark.parametrize("depth_rows", [False, True])
def test_from_map_state_and_solve_match_reference(tracked, depth_rows):
    ba = dataclasses.replace(tracked["cfg"].ba, depth_residuals=depth_rows)
    jd, jslots, jreal = jgba.from_map_state(tracked["jmap"],
                                            tracked["jintr"], ba, 8)
    td, tslots, treal = tgba.from_map_state(tracked["tmap"],
                                            tracked["tintr"], ba, 8)
    assert int(td.active.sum()) > 50
    np.testing.assert_array_equal(tslots.numpy(), np.asarray(jslots))
    np.testing.assert_array_equal(treal.numpy(), np.asarray(jreal))
    expect = convert.global_ba_data_to_torch(jax.device_get(jd), "cpu")
    for name, a, b in zip(tgba.GlobalBAData._fields, td, expect):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype.is_floating_point:
            torch.testing.assert_close(a, b, atol=1e-6, rtol=0, msg=name)
        else:
            assert torch.equal(a, b), name

    jo, jc, js = jgba.global_ba_solve(jd, tracked["jintr"], MESH1, iters=4,
                                      pcg_iters=20, depth_rows=depth_rows,
                                      return_stats=True)
    to, tc, ts = tgba.global_ba_solve(td, tracked["tintr"], iters=4,
                                      pcg_iters=20, depth_rows=depth_rows,
                                      return_stats=True)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4)
    for name in ("accepted", "retries", "pcg_iters"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))
    _close(to, jo, 1e-5, 1e-3)

    # write_back: the oldest real keyframe is the gauge, to the bit
    new = tgba.write_back(tracked["tmap"], to, tslots, treal)
    s = int(tslots[int(torch.argmax(treal.to(torch.int32)))])
    assert torch.equal(new.kf_q[s], tracked["tmap"].kf_q[s])
    assert torch.equal(new.kf_t[s], tracked["tmap"].kf_t[s])
    assert torch.isfinite(new.kf_t).all() and torch.isfinite(new.mp_pos).all()


def test_run_global_ba_on_map_matches_reference(tracked):
    jnew, jcosts = j_run_global_ba(tracked["jmap"], tracked["jintr"],
                                   tracked["cfg"].ba)
    tnew, tcosts = t_run_global_ba(tracked["tmap"], tracked["tintr"],
                                   tracked["cfg"].ba)
    np.testing.assert_allclose(tcosts, jcosts, rtol=1e-4)
    assert tcosts[-1] <= tcosts[0]
    for name in ("kf_t", "mp_pos"):
        np.testing.assert_allclose(getattr(tnew, name).numpy(),
                                   np.asarray(getattr(jnew, name)), atol=1e-5)
    for name in ("kf_id", "kf_mp", "num_kf", "num_mp"):
        assert torch.equal(getattr(tnew, name), getattr(tracked["tmap"], name))


def test_depth_rows_keep_keyframes_as_close_to_the_truth(tracked):
    """tests/test_global_ba_from_map.py:59-104 on the port: with the RGB-D
    depth rows the solve is monotone and its keyframes end no farther
    from the ground truth than the reprojection-only solve's (+1 mm)."""
    def solve(depth_rows):
        data, slots, real = tgba.from_map_state(
            tracked["tmap"], tracked["tintr"], tracked["cfg"].ba, 8)
        data, costs = tgba.global_ba_solve(data, tracked["tintr"], iters=5,
                                           pcg_iters=25,
                                           depth_rows=depth_rows)
        _monotone(costs.numpy())
        new = tgba.write_back(tracked["tmap"], data, slots, real)
        kf_t = new.kf_t.numpy()[new.kf_id.numpy() >= 0]
        return ate_rmse(kf_t, tracked["gt_kf"])

    ate_repro, ate_depth = solve(False), solve(True)
    assert ate_depth <= ate_repro + 1e-3, (ate_depth, ate_repro)
