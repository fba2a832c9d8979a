"""The port's dense reference LM solver (``kbslam_torch.ba.lm``) against
the JAX one, against the port's compact solver, and the BA gates of
tests/test_ba.py on the port.

Windows come from ``tests/test_ba.py:build_synthetic_state`` (five
keyframes observing 60 landmarks, noisy poses and points) with 0.3 px of
pixel noise, here with measured keypoint depths (the true depth plus 2 mm
of noise, ``test_torch_ba._state``) so that the depth rows take part when
``depth_residuals`` is on. Both solvers get the reference's problem.

Bounds of the port's ``solve_window`` against ``kbslam.ba.lm.
solve_window`` at a fixed ``max_iterations`` (3 and 20), seeds 0-2
(measured on the CPU in brackets):

- costs, initial and final, within 1e-5 relative (3.8e-6);
- with the depth rows: poses within 1e-5 m and 1e-4 deg (2.9e-7 m,
  4.5e-6 deg), landmarks within 1e-5 m (4.8e-7 m);
- without them, landmarks are triangulated from pixels alone and the
  solve walks a flat valley (``test_torch_ba``'s docstring): the
  relative-decrease stop is then decided by float32 rounding. At seed 1
  and 3 trips the reference stops after trip 2 and the port takes a
  third step along the valley, 0.11 mm and 0.0036 deg for the poses and
  2.5 mm for a landmark at a cost 1.6e-6 apart. So poses are held within
  2e-4 m and 0.005 deg, and landmarks by what the problem defines, as
  ``test_torch_ba`` holds them: their reprojection in every window
  camera that observes them within 0.05 px (0.0021 px) and their depth
  along the ray within 1e-3 of itself (5.0e-4).

Trip counts are not compared: the stop falls a trip early or late when
the summation order changes (ROADMAP.md §3).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from kbslam.ba.lm import solve_window as j_solve
from kbslam.ba.problem import build_problem as j_build
from kbslam_torch import config as tconfig
from kbslam_torch.ba.compact import compact_problem
from kbslam_torch.ba.compact_lm import solve_window_compact
from kbslam_torch.ba.local_ba import local_ba
from kbslam_torch.ba.lm import solve_window
from kbslam_torch.ba.problem import build_problem
from tests.test_ba import INTR, build_synthetic_state
from tests.test_torch_ba import (TINTR, _angle_deg, _cfgs, _problem_to_torch,
                                 _quat_to_matrix, _state, _t, _to_map)

torch.set_num_threads(1)
COST_REL = 1e-5
POSE_M, POSE_DEG, POINT_M = 1e-5, 1e-4, 1e-5               # depth rows on
VALLEY_POSE_M, VALLEY_POSE_DEG = 2e-4, 5e-3                 # depth rows off
REPROJ_PX, RAY_DEPTH_REL = 0.05, 1e-3


def _in_view(sol, prob):
    """Every active observation's landmark in its camera of ``sol``:
    (pixel [n, 2], depth along the optical axis [n])."""
    active = np.asarray(prob.active)
    w = np.nonzero(active)[0]
    X = np.asarray(sol.mp_pos, np.float64)[np.asarray(prob.mp_id)[active]]
    R = _quat_to_matrix(np.asarray(sol.cam_q))[w]
    pc = np.einsum("nji,nj->ni", R,
                   X - np.asarray(sol.cam_t, np.float64)[w])
    uv = np.stack([INTR.fx * pc[:, 0] / pc[:, 2] + INTR.cx,
                   INTR.fy * pc[:, 1] / pc[:, 2] + INTR.cy], -1)
    return uv, pc[:, 2]


@pytest.mark.parametrize("max_iterations", [3, 20])
@pytest.mark.parametrize("depth_rows", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_solve_window_matches_reference(seed, depth_rows, max_iterations):
    jc, tc = _cfgs(depth_residuals=depth_rows, max_iterations=max_iterations)
    state = _state(seed, px_noise=0.3)
    with jax.default_matmul_precision("highest"):
        jp = j_build(state, INTR, jc)
        js = jax.jit(lambda p, m: j_solve(p, m, INTR, jc))(jp, state.mp_pos)
    ts = solve_window(_problem_to_torch(jp), _t(state.mp_pos), TINTR, tc)

    for a, b in ((ts.initial_cost, js.initial_cost),
                 (ts.final_cost, js.final_cost)):
        assert abs(float(a) - float(b)) <= COST_REL * abs(float(b)), (a, b)
    assert float(ts.final_cost) < float(ts.initial_cost)
    dt = np.abs(ts.cam_t.numpy() - np.asarray(js.cam_t)).max()
    dq = _angle_deg(ts.cam_q.numpy(), js.cam_q).max()
    if depth_rows:
        assert dt < POSE_M and dq < POSE_DEG, (dt, dq)
        np.testing.assert_allclose(ts.mp_pos.numpy(), np.asarray(js.mp_pos),
                                   rtol=0, atol=POINT_M)
    else:
        assert dt < VALLEY_POSE_M and dq < VALLEY_POSE_DEG, (dt, dq)
        uv_t, z_t = _in_view(ts, jp)
        uv_j, z_j = _in_view(js, jp)
        px = np.linalg.norm(uv_t - uv_j, axis=-1).max()
        rel = (np.abs(z_t - z_j) / z_j).max()
        assert px < REPROJ_PX and rel < RAY_DEPTH_REL, (px, rel)
        # landmarks outside the window are left where they were
        seen = np.zeros(len(state.mp_pos), bool)
        seen[np.asarray(jp.mp_id)[np.asarray(jp.active)]] = True
        np.testing.assert_array_equal(ts.mp_pos.numpy()[~seen],
                                      np.asarray(state.mp_pos)[~seen])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_solver_matches_dense_reference(seed):
    """tests/test_ba.py::test_compact_solver_matches_dense_reference on
    the port, with its bounds: the production compact solver and the
    dense reference solver on the same window agree in costs, poses and
    landmark positions."""
    rng = np.random.default_rng(seed)
    state, _, _ = build_synthetic_state(rng, px_noise=0.3)
    cfg = tconfig.BAConfig()
    m = _to_map(state)
    prob = build_problem(m, TINTR, cfg)
    dense = solve_window(prob, m.mp_pos, TINTR, cfg)
    cp = compact_problem(prob, m.mp_pos, cfg.compact_obs,
                         cfg.compact_landmarks)
    comp = solve_window_compact(prob, cp, TINTR, cfg)

    assert np.isclose(float(dense.initial_cost), float(comp.initial_cost),
                      rtol=1e-4)
    assert np.isclose(float(dense.final_cost), float(comp.final_cost),
                      rtol=0.05, atol=1e-4), (
        float(dense.final_cost), float(comp.final_cost))
    np.testing.assert_allclose(comp.cam_t.numpy(), dense.cam_t.numpy(),
                               atol=1e-3)
    np.testing.assert_allclose(comp.cam_q.numpy(), dense.cam_q.numpy(),
                               atol=1e-3)
    lids = cp.uniq_global.numpy()
    lv = cp.l_valid.numpy()
    np.testing.assert_allclose(comp.Xc.numpy()[lv],
                               dense.mp_pos.numpy()[lids[lv]], atol=5e-3)


@pytest.mark.parametrize("solver", ["local_ba", "dense"])
def test_ba_reduces_cost_and_recovers_geometry(solver):
    """tests/test_ba.py::test_ba_reduces_cost_and_recovers_geometry on the
    port's local BA (the compact solver and its writeback) and on the
    dense solver over the same window, every bound unchanged."""
    rng = np.random.default_rng(1)
    state, pts_w, gt_poses = build_synthetic_state(rng)
    cfg = tconfig.BAConfig()
    m = _to_map(state)
    if solver == "local_ba":
        new, stats = local_ba(m, TINTR, cfg)
        kf_t, mp_pos = new.kf_t.numpy(), new.mp_pos.numpy()
        initial, final = float(stats.initial_cost), float(stats.final_cost)
    else:
        prob = build_problem(m, TINTR, cfg)
        sol = solve_window(prob, m.mp_pos, TINTR, cfg)
        kf_t = m.kf_t.numpy().copy()
        kf_t[prob.slots.numpy()] = sol.cam_t.numpy()
        mp_pos = sol.mp_pos.numpy()
        initial, final = float(sol.initial_cost), float(sol.final_cost)

    assert final < 0.01 * initial
    np.testing.assert_allclose(kf_t[4], gt_poses[4][1], atol=1e-6)
    for i in range(4):
        np.testing.assert_allclose(kf_t[i], gt_poses[i][1], atol=0.01)
    err = np.linalg.norm(mp_pos[:60] - pts_w, axis=1)
    assert np.median(err) < 0.01


@pytest.mark.parametrize("max_it", [3, 20])
def test_inner_iterations_converge_at_least_as_well(max_it):
    """tests/test_ba.py::test_inner_iterations_converge_at_least_as_well
    on the port's local BA: the landmark-only pass after accepted steps
    never ends at a higher cost, with its bound."""
    rng = np.random.default_rng(5)
    state, _, _ = build_synthetic_state(rng, px_noise=0.5)
    m = _to_map(state)
    cfg_p = dataclasses.replace(tconfig.BAConfig(), max_iterations=max_it)
    cfg_i = dataclasses.replace(cfg_p, inner_iterations=True)
    _, st_p = local_ba(m, TINTR, cfg_p)
    _, st_i = local_ba(m, TINTR, cfg_i)
    fp, fi = float(st_p.final_cost), float(st_i.final_cost)
    assert fi <= fp * 1.0 + 1e-4, (max_it, fi, fp)
    assert int(st_i.accepted) >= 1
