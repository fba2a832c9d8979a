"""The port's dense ICP against kbslam/mapping/icp.py.

On the fused spheres of tests/test_dense_icp.py:39-54 (12 frames of
320x240, 120x120x40 voxels of 5 cm, fused by the JAX package from the
ground-truth poses and handed to both packages as numpy arrays), and on
that file's two-submap atlas (frames 0-5 anchored at frame 2, 6-11 at
frame 8):

- ``pack_volume`` exact;
- ``_trilinear_sdf`` at seeded points: ``valid`` equal, phi within 1e-6
  and the gradient within 1e-4 per metre (float32 rounding of the same
  8-corner sums; the corner fetch itself is exact); the per-slot form
  of the atlas equals one call per slot;
- ``align_depth_to_tsdf`` and ``align_depth_to_atlas`` (K = 3, one slot
  repeated) from the perturbed pose of tests/test_dense_icp.py:57-79:
  the pose within 0.1 mm and 0.01 deg of JAX's, ``rmse_init`` and
  ``rmse`` within 1e-6 m, ``num_valid`` within 0.5%, the shells'
  acceptance decision equal, and that test's absolute gates on the
  port's result;
- a start at the ground truth stays within a quarter voxel;
- an empty volume gives ``num_valid == 0`` and the pose back unchanged;
- the atlas aligner follows re-posed anchors (tests/test_dense_icp.py:
  319-348).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbslam.config import DenseIcpConfig, DenseMapConfig
from kbslam.geom.camera import Intrinsics as JIntr
from kbslam.geom.se3 import SE3 as JSE3
from kbslam.io.synthetic import render_sequence
from kbslam.mapping import dense as jdense
from kbslam.mapping import icp as jicp
from kbslam.mapping import submap as jsub
from kbslam_torch import convert
from kbslam_torch.geom.camera import Intrinsics as TIntr
from kbslam_torch.mapping import icp as ticp
from kbslam_torch.mapping import submap as tsub
from kbslam_torch.slam import pose_T

torch.set_num_threads(1)

POSE_M = 1e-4
POSE_DEG = 0.01
RMSE_M = 1e-6
VALID_SHARE = 0.005
DELTA = [0.025, -0.02, 0.02, 0.012, -0.015, 0.010]


@functools.lru_cache(maxsize=1)
def _spheres():
    seq = render_sequence(num_frames=12, height=240, width=320,
                          scene="spheres")
    return seq, JIntr.from_matrix(seq.K), TIntr.from_matrix(seq.K)


@functools.lru_cache(maxsize=1)
def _fused():
    seq, ji, _ = _spheres()
    cfg = DenseMapConfig(voxel_size=0.05, dims=(120, 120, 40),
                         origin=(-3.0, -3.0, -1.6))
    st = jdense.integrate_sequence(seq.depth.astype(np.float32) * 0.001,
                                   seq.poses, ji, cfg)
    return cfg, jdense.TSDFState(*(np.asarray(a) for a in st))


@functools.lru_cache(maxsize=1)
def _atlas():
    seq, ji, _ = _spheres()
    cfg = DenseMapConfig(voxel_size=0.05, dims=(96, 96, 56),
                         origin=(-2.4, -2.4, 0.6))
    atlas = jsub.empty_atlas(cfg, 4)
    for anchor_i, frames in ((2, range(0, 6)), (8, range(6, 12))):
        Ta = JSE3.from_matrix(jnp.asarray(seq.poses[anchor_i], jnp.float32))
        atlas = jsub.start_submap(atlas, Ta.q, Ta.t, kf_id=anchor_i)
        for i in frames:
            Ti = JSE3.from_matrix(jnp.asarray(seq.poses[i], jnp.float32))
            atlas = jsub.integrate_active(
                atlas, jnp.asarray(seq.depth[i], jnp.float32) * 0.001,
                Ti.q, Ti.t, ji, cfg, Ta.q, Ta.t)
    return cfg, jsub.SubmapAtlas(*(np.asarray(a) for a in atlas))


def _pose(T):
    """float32 numpy (q, t) of a JAX SE3."""
    return np.array(T.q, np.float32), np.array(T.t, np.float32)


def _perturbed(i=6, G=None):
    seq = _spheres()[0]
    gt = JSE3.from_matrix(jnp.asarray(seq.poses[i], jnp.float32))
    if G is not None:
        gt = G @ gt
    return gt, JSE3.exp(jnp.array(DELTA)) @ gt


def _host(r):
    return {k: np.asarray(v.cpu() if torch.is_tensor(v) else v)
            for k, v in r._asdict().items()}


def _accepted(r, icp, refine):
    """The shells' gates (kbslam/slam.py:433-438) on a result."""
    ok = (int(r["num_valid"]) >= icp.min_points
          and float(r["rmse"]) <= icp.accept_rmse_m
          and float(r["rmse"]) <= float(r["rmse_init"]))
    return ok and (not refine or float(r["rmse"]) < float(r["rmse_init"]))


def _pose_err(q, t, T_ref):
    """(translation m, rotation deg) between (q, t) and a 4x4 pose."""
    dT = np.linalg.inv(T_ref) @ pose_T(np.asarray(q), np.asarray(t))
    ang = np.degrees(np.arccos(np.clip((np.trace(dT[:3, :3]) - 1) / 2,
                                       -1.0, 1.0)))
    return float(np.linalg.norm(dT[:3, 3])), float(ang)


def assert_result_close(t, j, icp):
    t, j = _host(t), _host(j)
    dt, dr = _pose_err(t["q"], t["t"], pose_T(j["q"], j["t"]))
    assert dt <= POSE_M and dr <= POSE_DEG, (dt, dr)
    for k in ("rmse_init", "rmse"):
        assert abs(float(t[k]) - float(j[k])) <= RMSE_M, (k, t[k], j[k])
    assert abs(int(t["num_valid"]) - int(j["num_valid"])) \
        <= VALID_SHARE * int(j["num_valid"])
    for refine in (False, True):
        assert _accepted(t, icp, refine) == _accepted(j, icp, refine)
    return t


def _depth(i):
    return _spheres()[0].depth[i]


def test_pack_volume_is_exact():
    _, st = _fused()
    j = jicp.pack_volume(jdense.TSDFState(*(jnp.asarray(a) for a in st)))
    t = ticp.pack_volume(convert.tsdf_to_torch(st, "cpu"))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert (t == 4.0).any() and (t < 2.0).any()


def test_trilinear_sdf_matches_reference():
    cfg, st = _fused()
    rng = np.random.default_rng(0)
    lo = np.asarray(cfg.origin) - 0.1
    hi = lo + np.asarray(cfg.dims) * cfg.voxel_size + 0.2
    X = rng.uniform(lo, hi, (50000, 3)).astype(np.float32)
    j = jicp._trilinear_sdf(jicp.pack_volume(jdense.TSDFState(
        *(jnp.asarray(a) for a in st))), cfg, jnp.asarray(X))
    packed = ticp.pack_volume(convert.tsdf_to_torch(st, "cpu"))
    t = ticp._trilinear_sdf(packed, cfg, torch.from_numpy(X))
    v = np.asarray(j[2])
    np.testing.assert_array_equal(t[2].numpy(), v)
    assert 1000 < v.sum() < len(v)
    np.testing.assert_allclose(t[0].numpy()[v], np.asarray(j[0])[v],
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(t[1].numpy()[v], np.asarray(j[1])[v],
                               atol=1e-4, rtol=0)
    # the per-slot form: slot k's points read slot k
    X2 = torch.from_numpy(np.stack([X, X[::-1].copy()]))
    two = torch.stack([packed, torch.full_like(packed, 0.5)])
    b = ticp._trilinear_sdf(two, cfg, X2)
    for k, (pk, Xk) in enumerate(zip(two, X2)):
        for got, want in zip(b, ticp._trilinear_sdf(pk, cfg, Xk)):
            assert torch.equal(got[k], want)


def _align_tsdf(state, q, t, icp, pkg):
    seq, ji, ti = _spheres()
    cfg = _fused()[0]
    if pkg == "jax":
        return jax.device_get(jicp.make_icp(cfg, icp, ji, 0.001)(
            jdense.TSDFState(*(jnp.asarray(a) for a in state)),
            jnp.asarray(_depth(6)), jnp.asarray(q), jnp.asarray(t)))
    return ticp.make_icp(cfg, icp, ti, 0.001)(
        convert.tsdf_to_torch(state, "cpu"),
        torch.from_numpy(_depth(6).astype(np.int32)), torch.from_numpy(q),
        torch.from_numpy(t))


def test_align_depth_to_tsdf_matches_reference():
    cfg, st = _fused()
    icp = DenseIcpConfig(iters=10)
    gt, pert = _perturbed()
    T_gt = pose_T(*_pose(gt))
    assert _pose_err(*_pose(pert), T_gt)[0] > 0.02
    t = assert_result_close(_align_tsdf(st, *_pose(pert), icp, "torch"),
                            _align_tsdf(st, *_pose(pert), icp, "jax"), icp)
    e_t, e_r = _pose_err(t["q"], t["t"], T_gt)
    assert int(t["num_valid"]) > 1000 and t["rmse"] < t["rmse_init"]
    assert e_t < 0.25 * cfg.voxel_size and e_r < 0.3, (e_t, e_r)


def test_zero_perturbation_is_stable():
    cfg, st = _fused()
    icp = DenseIcpConfig()
    gt, _ = _perturbed()
    t = assert_result_close(_align_tsdf(st, *_pose(gt), icp, "torch"),
                            _align_tsdf(st, *_pose(gt), icp, "jax"), icp)
    e_t, e_r = _pose_err(t["q"], t["t"], pose_T(*_pose(gt)))
    assert e_t < 0.25 * cfg.voxel_size and e_r < 0.3, (e_t, e_r)


def test_empty_volume_holds_the_pose():
    cfg, st = _fused()
    empty = jdense.TSDFState(np.ones_like(st.tsdf), np.zeros_like(st.weight))
    gt, _ = _perturbed(1)
    q, t = _pose(gt)
    r = _host(_align_tsdf(empty, q, t, DenseIcpConfig(), "torch"))
    assert int(r["num_valid"]) == 0
    np.testing.assert_array_equal(r["q"], q)
    np.testing.assert_array_equal(r["t"], t)


def _align_atlas(slots, aq, at, q, t, icp, pkg):
    _, ji, ti = _spheres()
    cfg, atlas = _atlas()
    if pkg == "jax":
        return jax.device_get(jicp.make_icp_atlas(cfg, icp, ji, 0.001)(
            jsub.SubmapAtlas(*(jnp.asarray(a) for a in atlas)),
            jnp.asarray(slots), jnp.asarray(aq), jnp.asarray(at),
            jnp.asarray(_depth(6)), jnp.asarray(q), jnp.asarray(t)))
    return ticp.make_icp_atlas(cfg, icp, ti, 0.001)(
        convert.atlas_to_torch(atlas, "cpu"), torch.from_numpy(slots),
        torch.from_numpy(aq), torch.from_numpy(at),
        torch.from_numpy(_depth(6).astype(np.int32)), torch.from_numpy(q),
        torch.from_numpy(t))


@pytest.mark.parametrize("reposed", [False, True])
def test_align_depth_to_atlas_matches_reference(reposed):
    """K = 3 over the two submaps, newest first, the older one repeated
    as the shells pad a short window; ``reposed``: every anchor moved by
    a rigid G (a correction), the truth then G T_gt."""
    cfg, atlas = _atlas()
    slots = np.array([1, 0, 0], np.int32)
    aq, at = atlas.anchor_q[slots].copy(), atlas.anchor_t[slots].copy()
    G = None
    if reposed:
        G = JSE3.exp(jnp.array([0.3, -0.2, 0.15, 0.08, -0.05, 0.06]))
        moved = G @ JSE3(jnp.asarray(aq), jnp.asarray(at))
        aq, at = np.array(moved.q), np.array(moved.t)
    icp = DenseIcpConfig(iters=10, atlas_slots=3)
    gt, pert = _perturbed(6, G)
    t = assert_result_close(
        _align_atlas(slots, aq, at, *_pose(pert), icp, "torch"),
        _align_atlas(slots, aq, at, *_pose(pert), icp, "jax"), icp)
    e_t, e_r = _pose_err(t["q"], t["t"], pose_T(*_pose(gt)))
    assert int(t["num_valid"]) > 1000 and t["rmse"] < t["rmse_init"]
    assert e_t < 0.25 * cfg.voxel_size and e_r < 0.3, (e_t, e_r)
    if not reposed:
        # the repeated slot changes nothing: K = 2 lands on the same pose
        two = _host(_align_atlas(slots[:2], aq[:2], at[:2], *_pose(pert),
                                 DenseIcpConfig(iters=10, atlas_slots=2),
                                 "torch"))
        np.testing.assert_allclose(two["t"], t["t"], atol=1e-5)


def test_slots_come_from_the_atlas_ring():
    """``recent_slots_with_poses`` builds the aligner's window: on the
    two-submap atlas with no map ring entry live it pads K = 3 with the
    older slot and hands the stored anchor poses."""
    from kbslam.config import MapConfig, SLAMConfig
    from kbslam.pipeline import init_state

    cfg, atlas = _atlas()
    m = convert.map_to_torch(init_state(SLAMConfig(map=MapConfig(
        max_keyframes=4, max_map_points=64))).map, "cpu")
    slots, aq, at = tsub.recent_slots_with_poses(
        convert.atlas_to_torch(atlas, "cpu"), m, 3)
    assert slots.tolist() == [1, 0, 0]
    np.testing.assert_array_equal(aq, atlas.anchor_q[slots])
    np.testing.assert_array_equal(at, atlas.anchor_t[slots])
