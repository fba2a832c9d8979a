"""The port's local bundle adjustment against the JAX reference.

Windows come from ``tests/test_ba.py:build_synthetic_state`` (five
keyframes observing 60 landmarks, noisy poses and points), here with
measured keypoint depths added (the true depth plus 2 mm of noise) so
that the RGB-D depth rows of the default objective take part. Both
packages get the same inputs; bounds:

- ``build_problem``: every int and bool field equal; floats within 1e-6
  (relative, and absolute for values near 0).
- ``compact_problem`` (given the reference's problem): every field equal,
  floats too, since the layout only selects and copies.
- ``solve_window_compact`` (given the reference's problem and layout),
  one LM trip and the default 20, with the depth rows on and off, inner
  iterations off and on, and 0 or 0.5 px of pixel noise: poses within
  1e-4 m and 0.005 deg, points within 1e-4 m, costs within 1e-3
  relative (plus 1e-6 absolute, for costs near 0). Sums by id run in
  another order than the reference's one-hot products, so where a
  converged solve's relative-decrease stop falls can move by a trip; the
  counts of trips are not compared.

  Without depth rows and with pixel noise, 20 trips do not pin a
  landmark's depth along its ray: it is triangulated from pixels alone,
  over a 0.6 m baseline at 2-5 m, and the solve stops in a flat valley.
  There the port stops after 6 trips and the reference after 7 (inner
  iterations off) or 20 (on), at costs 3e-6 apart, and 3 of the 12,288
  coordinates differ by up to 0.67 mm. This is not a difference of the LM
  step: capped at 6 trips the two agree to 5e-6 m, and moving the input
  landmarks by 1e-7 m moves the reference's own result by up to 0.37 mm
  and the port's by up to 1.2 mm, with stops anywhere from trip 4 to 20.
  So in these cases each valid landmark is held by what the problem
  defines: its reprojection in every window camera that observes it
  (each solution's own cameras) within 0.05 px, a tenth of the 0.5 px
  pixel noise, and its depth along the ray within 1e-3 of the depth, a
  fifth of the 1-sigma depth uncertainty that the noise leaves at the
  nearest landmark (z sigma / (f b) = 2.0 * 0.5 / (300 * 0.6) = 5.6e-3).
  Padding rows, poses and costs keep the bounds above.
- ``local_ba`` end to end: ``kf_mp`` and ``num_pruned`` equal; poses,
  points and costs within the bounds of the solve.
- A single keyframe is a no-op, equal bit for bit to the input and to the
  reference; a landmark whose observations all fail the chi^2 gate is
  pruned from the window as the reference prunes it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbslam.ba.compact import compact_problem as j_compact
from kbslam.ba.compact_lm import solve_window_compact as j_solve
from kbslam.ba.local_ba import local_ba as j_local_ba
from kbslam.ba.problem import build_problem as j_build
from kbslam_torch import config as tconfig
from kbslam_torch import convert
from kbslam_torch.ba.compact import CompactProblem, compact_problem as t_compact
from kbslam_torch.ba.compact_lm import solve_window_compact as t_solve
from kbslam_torch.ba.local_ba import local_ba as t_local_ba
from kbslam_torch.ba.problem import BAProblem, build_problem as t_build
from kbslam_torch.geom.camera import Intrinsics
from tests.test_ba import BCFG, INTR, build_synthetic_state

torch.set_num_threads(1)
TINTR = Intrinsics.create(INTR.fx, INTR.fy, INTR.cx, INTR.cy)
POSE_M, POSE_DEG, POINT_M, COST_REL, COST_ABS = 1e-4, 0.005, 1e-4, 1e-3, 1e-6
# landmarks triangulated from pixels alone (see the module docstring)
REPROJ_PX, RAY_DEPTH_REL = 0.05, 1e-3


def _cfgs(**kw):
    return (dataclasses.replace(BCFG, **kw),
            dataclasses.replace(tconfig.BAConfig(), **kw))


def _state(seed, px_noise=0.0, n_kf=5, depth=True):
    """build_synthetic_state plus measured depths at every observation."""
    rng = np.random.default_rng(seed)
    state, pts, gt = build_synthetic_state(rng, n_kf=n_kf, px_noise=px_noise)
    if depth:
        dep = np.zeros(state.kf_kp_depth.shape, np.float32)
        for i, (R, t) in enumerate(gt):
            z = ((pts - t) @ R)[:, 2]
            dep[i, :len(pts)] = z + rng.normal(scale=0.002, size=len(pts))
        state = state._replace(kf_kp_depth=jnp.asarray(dep))
    return state


def _t(x):
    return torch.from_numpy(np.array(np.asarray(x)))


def _problem_to_torch(jp) -> BAProblem:
    f = {k: _t(v) for k, v in jp._asdict().items() if k != "fixed_cam"}
    f["anchor_cam"] = f["anchor_cam"].to(torch.int64)
    return BAProblem(fixed_cam=int(jp.fixed_cam), **f)


def _assert_fields(t_tuple, j_tuple, rtol=0.0, atol=0.0):
    for name in j_tuple._fields:
        a, b = getattr(t_tuple, name), getattr(j_tuple, name)
        a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
        b = np.asarray(b)
        assert a.shape == b.shape, name
        if b.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def _angle_deg(qa, qb):
    """Rotation angle between unit quaternions, from the relative
    rotation's vector part (acos of a dot product near 1 would read the
    float32 rounding of the norms as degrees)."""
    a = np.asarray(qa, np.float64)
    b = np.asarray(qb, np.float64)
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    w = np.sum(a * b, axis=-1)
    v = a[..., :1] * b[..., 1:] - b[..., :1] * a[..., 1:] - np.cross(
        a[..., 1:], b[..., 1:])
    return np.degrees(2 * np.arctan2(np.linalg.norm(v, axis=-1), np.abs(w)))


def _assert_costs(t_cost, j_cost):
    t_cost, j_cost = float(t_cost), float(j_cost)
    assert abs(t_cost - j_cost) <= COST_REL * abs(j_cost) + COST_ABS, (
        t_cost, j_cost)


def _quat_to_matrix(q):
    """[..., 4] (w, x, y, z) unit quaternions -> [..., 3, 3] float64."""
    q = np.asarray(q, np.float64)
    w, x, y, z = np.moveaxis(q / np.linalg.norm(q, axis=-1, keepdims=True),
                             -1, 0)
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], -2)


def _in_view(sol, cp):
    """Every active observation's landmark in its camera of ``sol``:
    (pixel [n, 2], depth along the optical axis [n])."""
    valid = np.asarray(cp.obs_valid)
    w = np.asarray(cp.obs_w)[valid]
    X = np.asarray(sol.Xc, np.float64)[np.asarray(cp.obs_l)[valid]]
    R = _quat_to_matrix(np.asarray(sol.cam_q))[w]
    pc = np.einsum("nji,nj->ni", R, X - np.asarray(sol.cam_t, np.float64)[w])
    uv = np.stack([INTR.fx * pc[:, 0] / pc[:, 2] + INTR.cx,
                   INTR.fy * pc[:, 1] / pc[:, 2] + INTR.cy], -1)
    return uv, pc[:, 2]


def _assert_landmarks_in_view(ts, js, jcp):
    """The weakly posed cases' landmark measure (module docstring):
    reprojection within REPROJ_PX, depth within RAY_DEPTH_REL of itself;
    padding rows within POINT_M."""
    uv_t, z_t = _in_view(ts, jcp)
    uv_j, z_j = _in_view(js, jcp)
    px = np.linalg.norm(uv_t - uv_j, axis=-1)
    rel = np.abs(z_t - z_j) / z_j
    assert px.max() < REPROJ_PX, px.max()
    assert rel.max() < RAY_DEPTH_REL, rel.max()
    pad = ~np.asarray(jcp.l_valid)
    np.testing.assert_allclose(ts.Xc.numpy()[pad], np.asarray(js.Xc)[pad],
                               rtol=0, atol=POINT_M)


def _to_map(jstate):
    return convert.map_to_torch(jax.device_get(jstate), "cpu")


def _corrupt_landmark0(state):
    """Landmark 0 far off: every observation of it fails the chi^2 gate."""
    return state._replace(mp_pos=state.mp_pos.at[0].set(
        jnp.array([50.0, 50.0, 1.0])))


@pytest.mark.parametrize("case", ["default", "padded_window", "no_depth_rows",
                                  "corrupt_landmark"])
def test_build_problem_matches(case):
    state = _state(0, px_noise=0.5, n_kf=3 if case == "padded_window" else 5)
    if case == "corrupt_landmark":
        state = _corrupt_landmark0(state)
    jc, tc = _cfgs(depth_residuals=case != "no_depth_rows")
    with jax.default_matmul_precision("highest"):
        jp = j_build(state, INTR, jc)
    tp = t_build(_to_map(state), TINTR, tc)
    assert tp.fixed_cam == int(jp.fixed_cam)
    _assert_fields(tp, jp._replace(fixed_cam=tp.fixed_cam), rtol=1e-6,
                   atol=1e-6)
    if case == "padded_window":
        assert not np.asarray(jp.real).all()


@pytest.mark.parametrize("O,L", [(4096, 4096), (128, 32)])
def test_compact_problem_matches(O, L):
    """(128, 32) cuts the observations and the landmarks (60 in the
    window) short, as a crowded window does."""
    state = _state(1, px_noise=0.5)
    with jax.default_matmul_precision("highest"):
        jp = j_build(state, INTR, BCFG)
        jcp = j_compact(jp, state.mp_pos, O, L)
    tcp = t_compact(_problem_to_torch(jp), _t(state.mp_pos), O, L)
    _assert_fields(tcp, jcp)
    if L == 32:
        assert int(np.asarray(jcp.l_valid).sum()) == 32


@pytest.mark.parametrize("px_noise", [0.0, 0.5])
@pytest.mark.parametrize("inner", [False, True])
@pytest.mark.parametrize("depth_rows", [True, False])
@pytest.mark.parametrize("max_iterations", [1, 20])
def test_solve_window_compact_matches(max_iterations, depth_rows, inner,
                                      px_noise):
    jc, tc = _cfgs(depth_residuals=depth_rows, inner_iterations=inner,
                   max_iterations=max_iterations)
    state = _state(7, px_noise=px_noise)
    with jax.default_matmul_precision("highest"):
        jp = j_build(state, INTR, jc)
        jcp = j_compact(jp, state.mp_pos, jc.compact_obs, jc.compact_landmarks)
        js = jax.jit(lambda p, c: j_solve(p, c, INTR, jc))(jp, jcp)
    ts = t_solve(_problem_to_torch(jp), CompactProblem(*map(_t, jcp)), TINTR,
                 tc)
    np.testing.assert_allclose(ts.cam_t.numpy(), np.asarray(js.cam_t),
                               rtol=0, atol=POSE_M)
    assert _angle_deg(ts.cam_q.numpy(), js.cam_q).max() < POSE_DEG
    if depth_rows or px_noise == 0 or max_iterations == 1:
        np.testing.assert_allclose(ts.Xc.numpy(), np.asarray(js.Xc), rtol=0,
                                   atol=POINT_M)
    else:
        _assert_landmarks_in_view(ts, js, jcp)
    _assert_costs(ts.initial_cost, js.initial_cost)
    _assert_costs(ts.final_cost, js.final_cost)
    assert float(ts.final_cost) <= float(ts.initial_cost)
    if max_iterations == 1:
        assert int(ts.iterations) == int(js.iterations)
        assert int(ts.accepted) == int(js.accepted)


def _local_ba_pair(state, **kw):
    jc, tc = _cfgs(**kw)
    jn, jst = jax.jit(lambda s: j_local_ba(s, INTR, jc))(state)
    tm = _to_map(state)
    tn, tst = t_local_ba(tm, TINTR, tc)
    return tm, (tn, tst), (jn, jst)


@pytest.mark.parametrize("seed,px_noise,depth", [(1, 0.0, False), (2, 0.5, True),
                                                 (3, 0.5, True)])
def test_local_ba_matches(seed, px_noise, depth):
    state = _state(seed, px_noise=px_noise, depth=depth)
    _, (tn, tst), (jn, jst) = _local_ba_pair(state)
    np.testing.assert_array_equal(tn.kf_mp.numpy(), np.asarray(jn.kf_mp))
    assert int(tst.num_pruned) == int(jst.num_pruned)
    np.testing.assert_allclose(tn.kf_t.numpy(), np.asarray(jn.kf_t), rtol=0,
                               atol=POSE_M)
    assert _angle_deg(tn.kf_q.numpy(), jn.kf_q).max() < POSE_DEG
    np.testing.assert_allclose(tn.mp_pos.numpy(), np.asarray(jn.mp_pos),
                               rtol=0, atol=POINT_M)
    _assert_costs(tst.initial_cost, jst.initial_cost)
    _assert_costs(tst.final_cost, jst.final_cost)
    assert float(tst.final_cost) < float(tst.initial_cost)


def test_local_ba_leaves_its_input_alone():
    """The writeback is functional: the input map keeps its tensors and
    values, and the result shares no storage with the fields it wrote."""
    state = _state(2, px_noise=0.5)
    tm = _to_map(state)
    before = [t.clone() for t in tm]
    tn, _ = t_local_ba(tm, TINTR, tconfig.BAConfig())
    for a, b in zip(tm, before):
        assert torch.equal(a, b)
    for name in ("kf_q", "kf_t", "mp_pos", "kf_mp"):
        assert (getattr(tn, name).untyped_storage().data_ptr()
                != getattr(tm, name).untyped_storage().data_ptr())
    assert not torch.equal(tn.kf_t, tm.kf_t)


def test_single_keyframe_is_a_bit_equal_noop():
    state = _state(3, n_kf=1)
    tm, (tn, tst), (jn, _) = _local_ba_pair(state)
    for name in tm._fields:
        np.testing.assert_array_equal(getattr(tn, name).numpy(),
                                      getattr(tm, name).numpy(), err_msg=name)
        np.testing.assert_array_equal(getattr(tn, name).numpy(),
                                      np.asarray(getattr(jn, name)),
                                      err_msg=name)
    assert int(tst.num_pruned) == 0


def test_pruning_matches():
    """tests/test_ba.py:142-153 on both packages: landmark 0 is dropped
    from all window keyframes, the others stay."""
    state = _corrupt_landmark0(_state(4, depth=False))
    _, (tn, tst), (jn, jst) = _local_ba_pair(state)
    assert int(tst.num_pruned) == int(jst.num_pruned) >= 1
    kf_mp = tn.kf_mp.numpy()
    np.testing.assert_array_equal(kf_mp, np.asarray(jn.kf_mp))
    assert (kf_mp[:5, 0] == -1).all() and (kf_mp[:5, 1] == 1).all()
