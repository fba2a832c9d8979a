"""The port's raycast against kbslam/mapping/raycast.py.

The monolithic cases of tests/test_raycast.py, each fed to both packages
on one volume (numpy arrays): the analytic sphere's depth and normals,
miss semantics, ``render_consistency`` on a distorted camera and on the
fused plane, and ``render_view`` / ``map_consistency`` of the SLAM shell
(run with the JAX shell's minimal sets) against JAX's functions on the
shell's own volume. Also: ``render_view`` takes both of q and t or
neither, in ``SLAM`` and in ``ChunkedStream``.

Tolerance against JAX: ``hit`` equal on >= 99.9% of rays, and depth
within 1e-5 m and normals within 1e-4 on >= 99.9% of the rays both hit
(a sample that lies at a voxel's rounding edge may read the neighbour in
one float32 path: XLA fuses ``o + t * d`` and ``(x - origin) / voxel -
0.5`` into multiply-adds by the reciprocal, the port rounds each op);
``render_consistency``'s coverage within 1e-3 and its median and p90
within 1e-4 m. The analytic sphere seen from tests/test_raycast.py's
pose (no rotation, a step of 2.25 voxels) puts every fourth sample of
every ray exactly on a rounding edge, where the two round differently
(the port's median depth error there is 16.3 mm, JAX's 10.1 mm, both
within the gates): at that pose the port is held to that test's
analytic gates and ``hit`` equal, and at a rotated pose to the
tolerance above.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbslam.config import DenseMapConfig
from kbslam.geom.camera import Intrinsics as JIntr
from kbslam.geom.se3 import SE3 as JSE3
from kbslam.io.synthetic import render_sequence
from kbslam.mapping import dense as jdense
from kbslam.mapping import raycast as jray
from kbslam_torch import convert
from kbslam_torch.geom.camera import Intrinsics as TIntr
from kbslam_torch.geom.se3 import SE3 as TSE3
from kbslam_torch.mapping import raycast as tray
from test_torch_slam import _run

torch.set_num_threads(1)

MIN_AGREE = 0.999
DEPTH_TOL = 1e-5
NORMAL_TOL = 1e-4
METRIC_TOL = 1e-4


def sphere_state(cfg, center, radius):
    """Analytic sphere TSDF as numpy arrays (tests/test_raycast.py)."""
    nx, ny, nz = cfg.dims
    ii, jj, kk = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    X = np.asarray(cfg.origin) \
        + (np.stack([ii, jj, kk], -1) + 0.5) * cfg.voxel_size
    d = np.linalg.norm(X - np.asarray(center), axis=-1)
    t = np.clip((d - radius) / cfg.truncation, -1.0, 1.0)
    return jdense.TSDFState(tsdf=t.astype(np.float32),
                            weight=np.ones((nx, ny, nz), np.float32))


def both_renders(vol, q, t, cfg, intr_args, H, W, **kw):
    """(JAX RaycastResult, port RaycastResult) as numpy, on one volume."""
    q, t = np.asarray(q, np.float32), np.asarray(t, np.float32)
    j = jray.make_raycast(cfg, JIntr.create(*intr_args), H, W, **kw)(
        jdense.TSDFState(*(jnp.asarray(a) for a in vol)), jnp.asarray(q),
        jnp.asarray(t))
    r = tray.make_raycast(cfg, TIntr.create(*intr_args), H, W, **kw)(
        convert.tsdf_to_torch(vol, "cpu"), torch.from_numpy(q),
        torch.from_numpy(t))
    return ([np.asarray(a) for a in j], [a.numpy() for a in r])


def assert_render_close(j, t):
    (jd, jn, jh), (td, tn, th) = j, t
    assert (jh == th).mean() >= MIN_AGREE, (jh == th).mean()
    both = jh & th
    if both.any():
        assert (np.abs(jd - td)[both] <= DEPTH_TOL).mean() >= MIN_AGREE
        assert (np.abs(jn - tn).max(-1)[both] <= NORMAL_TOL).mean() \
            >= MIN_AGREE


def assert_metrics_close(m_t, m_j):
    assert abs(m_t["coverage"] - m_j["coverage"]) <= 1e-3, (m_t, m_j)
    for k in ("median_err_m", "p90_err_m"):
        assert abs(m_t[k] - m_j[k]) <= METRIC_TOL, (k, m_t, m_j)


SPHERE = DenseMapConfig(dims=(48, 48, 48), voxel_size=0.05,
                        origin=(-1.2, -1.2, -1.2), truncation=0.15)


def test_sphere_depth_and_normals_match_reference():
    R, H, W = 0.8, 120, 160
    intr = (100.0, 100.0, 79.5, 59.5)
    vol = sphere_state(SPHERE, (0, 0, 0), R)
    # a rotated pose off the sample lattice: the tolerance of the module
    q = np.array([0.99985, 0.01, -0.015, 0.005])
    assert_render_close(*both_renders(vol, q / np.linalg.norm(q),
                                      [0.05, -0.03, -1.97], SPHERE, intr,
                                      H, W, t_max=4.0))
    o = np.array([0.0, 0.0, -2.0])
    j, t = both_renders(vol, [1.0, 0, 0, 0], o, SPHERE, intr, H, W, t_max=4.0)
    assert (j[2] == t[2]).mean() >= MIN_AGREE
    depth, normal, hit = t
    gy, gx = np.mgrid[0:H, 0:W].astype(np.float64)
    xn, yn = (gx - intr[2]) / intr[0], (gy - intr[3]) / intr[1]
    a = xn ** 2 + yn ** 2 + 1.0
    b = 2.0 * (xn * o[0] + yn * o[1] + o[2])
    c = (o * o).sum() - R * R
    disc = b * b - 4 * a * c
    z_gt = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a), 0)
    interior = (disc > 0) & (disc > 0.05)
    assert hit[interior].mean() > 0.99
    dmin = np.sqrt(np.maximum(4 * a * c - b * b, 0) / (4 * a))
    assert hit[(disc <= 0) & (dmin > R + 1.5 * SPHERE.voxel_size)].mean() < 0.01
    err = np.abs(depth - z_gt)[interior & hit]
    assert np.median(err) < 0.5 * SPHERE.voxel_size
    assert np.percentile(err, 90) < SPHERE.voxel_size
    p = o + z_gt[..., None] * np.stack([xn, yn, np.ones_like(xn)], -1)
    rad = p / np.maximum(np.linalg.norm(p, axis=-1, keepdims=True), 1e-9)
    assert np.median((normal * rad).sum(-1)[interior & hit]) > 0.98


def test_miss_semantics_match_reference():
    cfg = DenseMapConfig(dims=(16, 16, 16), voxel_size=0.1,
                         origin=(-0.8, -0.8, 0.5), truncation=0.3)
    vol = sphere_state(cfg, (0, 0, 1.3), 0.3)
    j, t = both_renders(vol, [1.0, 0, 0, 0], [0.0, 0.0, 5.0], cfg,
                        (100.0, 100.0, 39.5, 29.5), 60, 80, t_max=3.0)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(a, b)
    depth, normal, hit = t
    assert not hit.any() and np.all(depth == 0) and np.all(normal == 0)


def test_render_consistency_distorted_camera_matches_reference():
    from kbslam_torch.geom.camera import undistort_points

    R, H, W = 0.8, 120, 160
    vol = sphere_state(SPHERE, (0, 0, 0), R)
    args = (100.0, 100.0, 79.5, 59.5, (-0.25, 0.06, 0.0, 0.0, 0.0))
    ti, ji = TIntr.create(*args), JIntr.create(*args)
    o = np.array([0.0, 0.0, -2.0], np.float32)
    q = np.array([1.0, 0, 0, 0], np.float32)
    gy, gx = np.mgrid[0:H, 0:W].astype(np.float32)
    uv = undistort_points(ti, torch.from_numpy(np.stack([gx, gy], -1))).numpy()
    xn, yn = (uv[..., 0] - ti.cx) / ti.fx, (uv[..., 1] - ti.cy) / ti.fy
    a = xn ** 2 + yn ** 2 + 1.0
    b = 2.0 * (xn * o[0] + yn * o[1] + o[2])
    c = float((o * o).sum()) - R * R
    disc = b * b - 4 * a * c
    ob = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a),
                  0.0).astype(np.float32)
    vol_t = convert.tsdf_to_torch(vol, "cpu")
    vol_j = jdense.TSDFState(*(jnp.asarray(x) for x in vol))

    def metrics(q, o):
        return (tray.render_consistency(
                    vol_t, TSE3(torch.from_numpy(q), torch.from_numpy(o)), ob,
                    ti, SPHERE, t_max=4.0),
                jray.render_consistency(
                    vol_j, JSE3(jnp.asarray(q), jnp.asarray(o)), ob, ji,
                    SPHERE, t_max=4.0))

    m_t, m_j = metrics(q, o)
    assert abs(m_t["coverage"] - m_j["coverage"]) <= 1e-3, (m_t, m_j)
    assert m_t["coverage"] > 0.1
    assert m_t["median_err_m"] < 0.5 * SPHERE.voxel_size
    assert m_t["p90_err_m"] < 1.5 * SPHERE.voxel_size
    # the metric itself, at a rotated pose off the sample lattice
    q_r = np.array([0.99985, 0.01, -0.015, 0.005], np.float32)
    assert_metrics_close(*metrics(q_r / np.linalg.norm(q_r),
                                  np.array([0.05, -0.03, -1.97], np.float32)))


def test_render_consistency_on_fused_plane_matches_reference():
    from kbslam_torch.mapping.dense import _rot_to_quat

    seq = render_sequence(num_frames=10, height=240, width=320)
    cfg = DenseMapConfig(origin=(-4.08, -4.08, -1.36))
    st = jdense.integrate_sequence(seq.depth.astype(np.float32) * 0.001,
                                   seq.poses, JIntr.from_matrix(seq.K), cfg)
    vol = jdense.TSDFState(*(np.asarray(a) for a in st))
    T5 = seq.poses[5].astype(np.float32)
    q, t = _rot_to_quat(T5[:3, :3]).astype(np.float32), T5[:3, 3]
    obs = seq.depth[5].astype(np.float32) * 0.001
    m_t = tray.render_consistency(
        convert.tsdf_to_torch(vol, "cpu"),
        TSE3(torch.from_numpy(q), torch.from_numpy(t)), obs,
        TIntr.from_matrix(seq.K), cfg)
    m_j = jray.render_consistency(st, JSE3(jnp.asarray(q), jnp.asarray(t)),
                                  obs, JIntr.from_matrix(seq.K), cfg)
    assert_metrics_close(m_t, m_j)
    assert m_t["coverage"] > 0.5 and m_t["median_err_m"] < cfg.voxel_size
    assert m_t["p90_err_m"] < 3 * cfg.voxel_size


def _dense_cfg():
    from kbslam.config import MapConfig, OrbConfig, PnPConfig, SLAMConfig

    cfg = SLAMConfig(
        image_height=240, image_width=320,
        orb=OrbConfig(num_features=512, num_levels=4, max_features=512),
        pnp=PnPConfig(num_hypotheses=128),
        map=MapConfig(max_keyframes=16, max_map_points=8192))
    return cfg.replace(dense=dataclasses.replace(cfg.dense, enabled=True))


def test_slam_render_view_and_map_consistency_match_reference():
    seq = render_sequence(num_frames=14, height=240, width=320,
                          scene="spheres")
    cfg = _dense_cfg()
    _, s = _run(seq, cfg, "disabled")
    r = s.render_view()
    hit = r.hit.numpy()
    assert int(hit.sum()) > 1000 and r.depth.shape == (240, 320)
    assert float(r.depth.max()) > 0.5
    vol = convert.tsdf_to_numpy(s.tsdf)
    q, t, depth, _ = s._last_kf_view
    intr = (s.intr.fx, s.intr.fy, s.intr.cx, s.intr.cy)
    j, tt = both_renders(vol, q, t, cfg.dense, intr, 240, 320)
    for a, b in zip(tt, r):
        np.testing.assert_array_equal(a, b.numpy())
    assert_render_close(j, tt)
    # the same render at stride 4 is the full render's every 4th pixel
    # to within the tolerance
    r4 = s.render_view(stride=4)
    assert r4.depth.shape == (60, 80)
    assert (r4.hit.numpy() == hit[::4, ::4]).mean() >= 0.99
    m = s.map_consistency()
    assert m["coverage"] > 0.3 and m["median_err_m"] < cfg.dense.voxel_size
    ji = JIntr.create(s.intr.fx / 2, s.intr.fy / 2, s.intr.cx / 2,
                      s.intr.cy / 2)
    m_j = jray.render_consistency(
        jdense.TSDFState(*(jnp.asarray(a) for a in vol)),
        JSE3(jnp.asarray(q, jnp.float32), jnp.asarray(t, jnp.float32)),
        depth[::2, ::2].astype(np.float32) * cfg.map.depth_scale, ji,
        cfg.dense)
    assert_metrics_close(m, m_j)


def test_render_view_takes_both_of_q_and_t_or_neither():
    from kbslam_torch.pipeline import init_state
    from kbslam_torch.slam import SLAM
    from kbslam_torch.streaming import ChunkedStream

    seq = render_sequence(num_frames=2, height=120, width=160)
    cfg = _dense_cfg().replace(image_height=120, image_width=160)
    shells = [SLAM(cfg, seq.K, ba_mode="disabled", use_mask=False,
                   device="cpu"),
              ChunkedStream(cfg, TIntr.from_matrix(seq.K),
                            init_state(cfg, "cpu"), chunk=2)]
    q, t = np.array([1.0, 0, 0, 0]), np.zeros(3)
    for shell in shells:
        assert shell.render_view() is None        # nothing fused yet
        assert shell.map_consistency() is None
        with pytest.raises(ValueError):
            shell.render_view(q=q)
        with pytest.raises(ValueError):
            shell.render_view(t=t)
        r = shell.render_view(q, t, stride=2)     # an empty volume: misses
        assert r.depth.shape == (60, 80) and not bool(r.hit.any())
