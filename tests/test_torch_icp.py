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

And the contract of the CUDA fetch kernel's plain twin (``ops/icp.py``), on
the same spheres and atlas:

- the in-place fetch (``weight > 0`` as the observed test) equals the
  packed fetch exactly, with a slot repeated and an unobserved corner;
- each point takes the first valid slot, newest first;
- ``_gn_align`` fetches once a trip and once more, whatever the fetch;
- an empty model gives ``num_valid == 0`` and the pose back unchanged;
- ``_check`` and ``_check_pose`` reject what the kernel does not take,
  and CPU tensors take the twin, leaving ``launches`` at 0.
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
from kbslam_torch.geom.se3 import quat_rotate, quat_to_matrix
from kbslam_torch.mapping.dense import TSDFState
from kbslam_torch.mapping import icp as ticp
from kbslam_torch.mapping import submap as tsub
from kbslam_torch.ops import icp as icp_ops
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



def _twin_args(case, unobserved=False, empty=False, pose=None):
    """(``ops.icp.align``'s arguments on the CPU, the point made
    unobserved or None): frame 6's points at stride 4 from ``pose``
    (default the perturbed one), 10 trips, against ("atlas") the
    two-submap atlas with the window [1, 0, 0] and its stored anchors,
    or ("volume") the fused volume as a ring of one read in world
    coordinates. ``unobserved``: one corner of a point that reads the
    window's first slot loses its weight (its tsdf stays in [-1, 1]);
    ``empty``: every weight 0."""
    _, _, ti = _spheres()
    if case == "atlas":
        cfg, atlas = _atlas()
        slots = np.array([1, 0, 0], np.int32)
        vols = (atlas.tsdf, atlas.weight, slots, atlas.anchor_q[slots],
                atlas.anchor_t[slots])
    else:
        cfg, st = _fused()
        vols = (st.tsdf[None], st.weight[None], np.zeros(1, np.int32),
                None, None)
    tsdf, weight, slots, aq, at = (None if a is None else
                                   torch.from_numpy(np.array(a))
                                   for a in vols)
    p_cam, p_ok = ticp._frame_points(
        torch.from_numpy(_depth(6).astype(np.float32)) * 0.001, ti, cfg, 4)
    q, t = (torch.from_numpy(a) for a in _pose(
        _perturbed()[1] if pose is None else pose))
    if empty:
        weight.zero_()
    p = None
    if unobserved:
        X = quat_rotate(q, p_cam) + t
        valid = icp_ops.fetch_slots(tsdf, weight, slots, aq, at, cfg, X)[2]
        p = int(torch.nonzero(valid[0] & p_ok)[0])
        Xl = _local(X[p:p + 1], aq, at)[:1]
        idx = icp_ops.corners(cfg, Xl, int(slots[0]) * weight[0].numel())[0]
        weight.view(-1)[idx[0, 0, 5]] = 0.0
        assert abs(float(tsdf.view(-1)[idx[0, 0, 5]])) <= 1.0
    return (tsdf, weight, slots, aq, at, p_cam, p_ok, q, t, cfg,
            DenseIcpConfig(iters=10)), p


def _local(X, aq, at):
    """World points X [P, 3] in each anchor's frame, [K, P, 3] (the
    world itself, [1, P, 3], without anchors)."""
    if aq is None:
        return X[None]
    return torch.matmul(X[None] - at[:, None], quat_to_matrix(aq))


@pytest.mark.parametrize("case", ["volume", "atlas"])
@pytest.mark.parametrize("unobserved", [False, True])
def test_in_place_fetch_equals_the_packed_fetch(case, unobserved):
    """``fetch_slots`` reads each slot's tsdf and weight in place; the
    JAX package's form packs each slot with the sentinel first
    (``pack_volume``, ``_trilinear_sdf``): phi, gradient and valid are
    equal to the bit, with the window's repeated slot and with an
    unobserved corner whose tsdf looks like a fused one."""
    (tsdf, weight, slots, aq, at, p_cam, p_ok, q, t, cfg, _), p = \
        _twin_args(case, unobserved)
    X = quat_rotate(q, p_cam) + t
    phis, grads, valids = icp_ops.fetch_slots(tsdf, weight, slots, aq, at,
                                              cfg, X)
    packed = torch.stack([ticp.pack_volume(TSDFState(tsdf[s], weight[s]))
                          for s in slots.tolist()])
    phi, grad, valid = ticp._trilinear_sdf(
        packed, cfg, _local(X, aq, at).expand(len(slots), -1, -1))
    if aq is not None:
        grad = torch.matmul(grad, quat_to_matrix(aq).transpose(1, 2))
    assert torch.equal(valids, valid)
    assert torch.equal(phis, phi) and torch.equal(grads, grad)
    assert 1000 < int(valid[0].sum()) < valid.shape[1]
    if unobserved:
        assert not valid[0, p]


@pytest.mark.parametrize("unobserved", [False, True])
def test_each_point_takes_its_first_valid_slot(unobserved):
    """The kernel's rule, walking the slots newest first and stopping at
    the first valid one, picks the slot of the twin's ``argmax``
    selection, and ``fetch_reference`` returns that slot's values."""
    (tsdf, weight, slots, aq, at, p_cam, p_ok, q, t, cfg, _), p = \
        _twin_args("atlas", unobserved)
    X = quat_rotate(q, p_cam) + t
    phis, grads, valids = icp_ops.fetch_slots(tsdf, weight, slots, aq, at,
                                              cfg, X)
    first = torch.full(X.shape[:1], -1)
    for k in range(len(slots)):
        first = torch.where((first < 0) & valids[k], k, first)
    found = first >= 0
    assert torch.equal(first[found],
                       torch.argmax(valids.to(torch.uint8), dim=0)[found])
    phi, grad, valid = icp_ops.fetch_reference(tsdf, weight, slots, aq, at,
                                               cfg, X)
    pts = torch.arange(X.shape[0])[found]
    assert torch.equal(valid, found)
    assert torch.equal(phi[found], phis[first[found], pts])
    assert torch.equal(grad[found], grads[first[found], pts])
    assert (phi[~found] == 0).all() and (first > 0).any()
    if unobserved:
        assert first[p] != 0


@pytest.mark.parametrize("iters", [0, 3, 10])
def test_gn_align_fetches_once_a_trip_and_once_more(iters):
    """``_gn_align`` drives any fetch (on the card the kernel's): iters + 1
    fetches, each at the pose the trip before left, the stats from the
    first and the last (none before the solve when iters is 0), and the
    atlas twin's result when the fetch is the twin's."""
    args, _ = _twin_args("atlas")
    tsdf, weight, slots, aq, at, p_cam, p_ok, q, t, cfg, _ = args
    icp = DenseIcpConfig(iters=iters)
    sdf = functools.partial(icp_ops.fetch_reference, tsdf, weight, slots,
                            aq, at, cfg)
    seen = []

    def fetch(qk, tk):
        seen.append((qk, tk))
        return icp_ops._residuals(sdf, cfg, icp, p_cam, p_ok, qk, tk)

    got = icp_ops._gn_align(fetch, q, t, icp)
    want = icp_ops.align_reference(*args[:-1], icp)
    assert len(seen) == iters + 1
    assert torch.equal(seen[0][0], q) and torch.equal(seen[-1][0], got[0])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    first = fetch(q, t)
    assert int(got[2]) == (0 if iters == 0 else
                           min(int(first[4]), int(fetch(*got[:2])[4])))
    assert float(got[3]) == (0.0 if iters == 0 else float(first[5]))


@pytest.mark.parametrize("case", ["volume", "atlas"])
def test_twins_on_an_empty_model_hold_the_pose(case):
    """Every weight 0: no point is valid in any fetch, ``align`` gives
    ``num_valid == 0`` and the pose back unchanged (the guard holds it)."""
    (tsdf, weight, slots, aq, at, p_cam, p_ok, q, t, cfg, icp), _ = \
        _twin_args(case, empty=True, pose=_perturbed(1)[0])
    X = quat_rotate(q, p_cam) + t
    assert not icp_ops.fetch_reference(tsdf, weight, slots, aq, at, cfg,
                                       X)[2].any()
    r = icp_ops.align(tsdf, weight, slots, aq, at, p_cam, p_ok, q, t, cfg,
                      icp)
    assert int(r[2]) == 0
    assert torch.equal(r[0], q) and torch.equal(r[1], t)


def test_check_rejects_what_the_kernel_does_not_take():
    """``ops.icp._check`` passes the atlas's arguments and raises on a
    wrong dtype, a wrong shape, a non-contiguous tensor or a lone
    anchor."""
    args, _ = _twin_args("atlas")
    good = list(args[:7]) + [args[9]]
    icp_ops._check(*good)
    tsdf, weight, slots, aq, at, p_cam, p_ok, cfg = good
    bad = [(0, tsdf.double()), (1, weight.half()), (2, slots.long()),
           (6, p_ok.to(torch.uint8)), (0, tsdf[:, :-1].contiguous()),
           (2, slots[:2]), (3, aq[:, :3].contiguous()),
           (5, p_cam[:, :2].contiguous()), (6, p_ok[1:]),
           (0, tsdf.transpose(1, 2)), (5, p_cam.t().contiguous().t()),
           (4, None)]
    for i, x in bad:
        a = list(good)
        a[i] = x
        with pytest.raises(ValueError):
            icp_ops._check(*a)


def test_check_pose_rejects_what_the_kernel_does_not_take():
    """``ops.icp._check_pose`` passes the start pose and raises on a wrong
    dtype, a wrong shape or another device."""
    args, _ = _twin_args("atlas")
    q, t = args[7:9]
    cpu = torch.device("cpu")
    icp_ops._check_pose(q, t, cpu)
    for bad in ((q.double(), t), (q, t.half()), (q[:3], t), (q, t[None]),
                (q, t.to("meta"))):
        with pytest.raises(ValueError):
            icp_ops._check_pose(*bad, cpu)


def test_cpu_tensors_take_the_twin():
    """On the CPU ``align`` is ``align_reference`` and launches nothing,
    through the aligner's own entry too."""
    args, _ = _twin_args("atlas")
    icp_ops.reset_launches()
    got = icp_ops.align(*args)
    for a, b in zip(got, icp_ops.align_reference(*args)):
        assert torch.equal(a, b)
    _align_atlas(np.array([1, 0, 0], np.int32),
                 *(a.numpy() for a in args[3:5]),
                 *(a.numpy() for a in args[7:9]), args[-1], "torch")
    assert icp_ops.launches == 0
