"""The port's monolithic TSDF volume against kbslam/mapping/dense.py.

The cases of tests/test_dense.py, each fed to both packages from the
same numpy inputs (depth made by ``render_sequence`` from its seed):

- plane accuracy with ground-truth poses and the truncation and
  free-space semantics of one wall, against JAX ``integrate_sequence``
  and ``integrate``;
- the distorted camera, against JAX the same way, and that test's gates;
- the SLAM shell end to end with the JAX shell's minimal sets injected:
  weights equal on >= 99% of voxels, and the surface on the analytic
  plane; a shell without dense mapping refuses ``dense_surface``;
- the CLI with ``--dense --save-surface`` at 160x120;
- ``ChunkedStream`` fuses the same volume as per-frame ``SLAM``;
- the volume through a checkpoint and ``--resume``, and the ``tsdf`` of
  a checkpoint the JAX package wrote.

Tolerance against JAX (``assert_volume_close``): weights equal and tsdf
within 1e-6 on every voxel whose projected u and v, recomputed in
float64, lie 1e-3 px or more from a .5 rounding edge in every fused
frame, and on >= 99.9% of all voxels. Nearer an edge the two float32
paths may read neighbouring pixels.
"""
import dataclasses
import json
import sys
from io import StringIO

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbslam.config import DenseMapConfig
from kbslam.geom.camera import Intrinsics as JIntr
from kbslam.geom.se3 import SE3 as JSE3
from kbslam.io.synthetic import render_sequence
from kbslam.mapping import dense as jdense
from kbslam_torch import convert
from kbslam_torch.geom.camera import Intrinsics as TIntr
from kbslam_torch.geom.se3 import SE3 as TSE3
from kbslam_torch.mapping import dense as tdense
from test_torch_slam import _run

torch.set_num_threads(1)

TSDF_TOL = 1e-6
EDGE_PX = 1e-3
MIN_AGREE = 0.999


def _quat_matrix(q):
    w, x, y, z = (float(c) for c in q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def near_round_edge(cfg, intr, poses_qt):
    """[V] bool: voxels whose projected u or v (float64, through the
    distortion model when the camera has one) lie within EDGE_PX of a .5
    rounding edge in any of the (q, t) camera-to-world poses."""
    axes = [cfg.origin[a] + (np.arange(n) + 0.5) * cfg.voxel_size
            for a, n in enumerate(cfg.dims)]
    X = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    near = np.zeros(len(X), bool)
    for q, t in poses_qt:
        Xc = (X - np.asarray(t, np.float64)) @ _quat_matrix(q)
        z = np.where(Xc[:, 2] > 0, Xc[:, 2], 1.0)
        x, y = Xc[:, 0] / z, Xc[:, 1] / z
        if any(intr.dist):
            k1, k2, p1, p2, k3 = intr.dist
            r2 = x * x + y * y
            rad = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
            x, y = (x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x),
                    y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y)
        for p in (intr.fx * x + intr.cx, intr.fy * y + intr.cy):
            near |= np.abs(p - np.floor(p) - 0.5) < EDGE_PX
    return near


def assert_volume_close(t_state, j_state, cfg, intr, poses_qt):
    """The port's volume against the JAX package's at the stated
    tolerance (module docstring)."""
    tt, tw = (a.reshape(-1) for a in convert.tsdf_to_numpy(t_state))
    jt, jw = (np.asarray(a).reshape(-1) for a in j_state)
    agree = (tw == jw) & (np.abs(tt - jt) <= TSDF_TOL)
    away = ~near_round_edge(cfg, intr, poses_qt)
    assert agree[away].all(), (int((~agree & away).sum()),
                               float(np.abs(tt - jt)[away].max()))
    assert agree.mean() >= MIN_AGREE, agree.mean()
    assert (jw > 0).sum() > 0


def _gt_qt(poses):
    return [(tdense._rot_to_quat(np.asarray(P, np.float32)[:3, :3]),
             np.asarray(P, np.float32)[:3, 3]) for P in poses]


def test_tsdf_plane_with_gt_poses_matches_reference():
    seq = render_sequence(num_frames=12, height=240, width=320)
    cfg = DenseMapConfig(origin=(-4.08, -4.08, -1.36))
    depth = seq.depth.astype(np.float32) * 0.001
    j = jdense.integrate_sequence(depth, seq.poses, JIntr.from_matrix(seq.K),
                                  cfg)
    intr = TIntr.from_matrix(seq.K)
    t = tdense.integrate_sequence(depth, seq.poses, intr, cfg, device="cpu")
    assert_volume_close(t, j, cfg, intr, _gt_qt(seq.poses))
    pts, _ = tdense.surface_points(t, cfg)
    assert len(pts) > 2000, len(pts)
    err = np.abs(pts[:, 2])     # the analytic plane z = 0
    assert np.median(err) < 0.005 and np.percentile(err, 90) < 0.02


def test_truncation_and_freespace_match_reference():
    cfg = DenseMapConfig(dims=(32, 32, 64), voxel_size=0.05,
                         origin=(-0.8, -0.8, 0.0), truncation=0.15)
    H, W = 120, 160
    depth = np.full((H, W), 2.0, np.float32)    # a wall at z = 2 m
    q, t0 = np.array([1.0, 0, 0, 0], np.float32), np.zeros(3, np.float32)
    ji = JIntr.create(fx=130.0, fy=130.0, cx=79.5, cy=59.5)
    j = jdense.integrate(jdense.empty_tsdf(cfg), jnp.asarray(depth),
                         JSE3(jnp.asarray(q), jnp.asarray(t0)), ji, cfg)
    ti = TIntr.create(fx=130.0, fy=130.0, cx=79.5, cy=59.5)
    st = tdense.integrate(tdense.empty_tsdf(cfg, "cpu"),
                          torch.from_numpy(depth),
                          TSE3(torch.from_numpy(q), torch.from_numpy(t0)),
                          ti, cfg)
    assert_volume_close(st, j, cfg, ti, [(q, t0)])
    tv, wv = (a.numpy() for a in st)
    zs = cfg.origin[2] + (np.arange(64) + 0.5) * cfg.voxel_size
    col_t, col_w = tv[16, 16], wv[16, 16]
    front = (zs > 0.3) & (zs < 2.0 - cfg.truncation)
    band = np.abs(zs - 2.0) < cfg.truncation * 0.5
    assert np.all(col_w[front] > 0) and np.all(col_t[front] > 0.99)
    assert np.all(col_w[band] > 0) and np.all(np.abs(col_t[band]) < 0.6)
    assert np.all(col_w[zs > 2.0 + cfg.truncation] == 0)
    behind = (zs > 2.03) & (zs < 2.0 + cfg.truncation * 0.9)
    assert np.all(col_t[behind][col_w[behind] > 0] < 0)


def test_distorted_camera_matches_reference():
    from scipy.ndimage import map_coordinates

    from kbslam_torch.geom.camera import undistort_points

    dist = (0.22, -0.4, 0.0, 0.0, 0.0)
    seq = render_sequence(num_frames=10, height=240, width=320)
    h, w = 240, 320
    intr_d = TIntr.from_matrix(seq.K, dist=dist)
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
    src = undistort_points(intr_d, torch.from_numpy(
        np.stack([gx.ravel(), gy.ravel()], 1))).numpy()
    coords = np.stack([src[:, 1].reshape(h, w), src[:, 0].reshape(h, w)])
    dep = np.stack([map_coordinates(f.astype(np.float32), coords, order=0,
                                    mode="nearest") for f in seq.depth]) * 0.001
    cfg = DenseMapConfig(origin=(-4.08, -4.08, -1.36))
    out = {}
    for d in (dist, None):
        t = tdense.integrate_sequence(dep, seq.poses,
                                      TIntr.from_matrix(seq.K, dist=d), cfg,
                                      device="cpu")
        j = jdense.integrate_sequence(dep, seq.poses,
                                      JIntr.from_matrix(seq.K, dist=d), cfg)
        assert_volume_close(t, j, cfg, TIntr.from_matrix(seq.K, dist=d),
                            _gt_qt(seq.poses))
        pts, _ = tdense.surface_points(t, cfg)
        out[d is None] = (pts, np.abs(pts[:, 2]))
    (pts_d, err_d), (pts_0, err_0) = out[False], out[True]
    assert len(pts_d) < 1.2 * len(pts_0), (len(pts_d), len(pts_0))
    assert np.median(err_d) < 0.005
    assert np.percentile(err_d, 90) < np.percentile(err_0, 90)


def _cfg240(dense=True):
    from kbslam.config import MapConfig, OrbConfig, PnPConfig, SLAMConfig

    cfg = SLAMConfig(
        image_height=240, image_width=320,
        orb=OrbConfig(num_features=512, num_levels=4, max_features=512),
        pnp=PnPConfig(num_hypotheses=128),
        map=MapConfig(max_keyframes=16, max_map_points=8192))
    return cfg.replace(dense=dataclasses.replace(cfg.dense, enabled=dense))


def test_slam_dense_end_to_end_matches_reference():
    from kbslam_torch.slam import SLAM

    seq = render_sequence(num_frames=30, height=240, width=320)
    j, t = _run(seq, _cfg240(), "on_keyframe")
    assert ([d["added_kf"] for d in t.diagnostics]
            == [d["added_kf"] for d in j.diagnostics])
    tw = t.tsdf.weight.numpy()
    jw = np.asarray(j.tsdf.weight)
    assert (tw == jw).mean() >= 0.99, (tw == jw).mean()
    pts, _ = t.dense_surface()
    assert len(pts) > 1000, len(pts)
    T0 = seq.poses[0]      # the SLAM world is camera 0: the plane is z = 0
    err = np.abs((pts @ T0[:3, :3].T + T0[:3, 3])[:, 2])
    assert np.median(err) < 0.02, np.median(err)
    off = SLAM(_cfg240(dense=False), seq.K, ba_mode="disabled",
               use_mask=False, device="cpu")
    with pytest.raises(RuntimeError):
        off.dense_surface()


def _cli(argv):
    from kbslam_torch.cli import main

    cap, old = StringIO(), sys.stdout
    sys.stdout = cap
    try:
        main(["--device", "cpu"] + argv)
    finally:
        sys.stdout = old
    return json.loads(cap.getvalue().strip().splitlines()[-1])


def test_cli_dense_save_surface(tmp_path):
    out = tmp_path / "surf.npy"
    summary = _cli(["--frames", "16", "--width", "160", "--height", "120",
                    "--ba", "off", "--dense", "--save-surface", str(out)])
    assert summary["tsdf_observed_voxels"] > 0
    assert summary["tsdf_surface_points"] > 0
    pts = np.load(out)
    assert pts.shape[1] == 3 and len(pts) == summary["tsdf_surface_points"]


def test_chunked_dense_equals_per_frame():
    from kbslam_torch.pipeline import init_state
    from kbslam_torch.slam import SLAM
    from kbslam_torch.streaming import ChunkedStream

    seq = render_sequence(num_frames=24, height=240, width=320)
    cfg = _cfg240()
    s = SLAM(cfg, seq.K, ba_mode="disabled", use_mask=False, device="cpu")
    cs = ChunkedStream(cfg, TIntr.from_matrix(seq.K), init_state(cfg, "cpu"),
                       chunk=8)
    got = []
    for i in range(24):
        s.process(seq.rgb[i], seq.depth[i])
        got += cs.feed(seq.rgb[i], seq.depth[i])
    got += cs.flush()
    assert len(got) == 24
    assert not cs._depth_ring, "the depth ring must drain"
    assert s.num_keyframes >= 2
    assert torch.equal(cs.tsdf.weight, s.tsdf.weight)
    assert float((cs.tsdf.tsdf - s.tsdf.tsdf).abs().max()) <= TSDF_TOL
    for a, b in zip(cs._last_kf_view[:2], s._last_kf_view[:2]):
        np.testing.assert_array_equal(a, b)


def test_dense_checkpoint_roundtrip_and_reference_checkpoint(tmp_path):
    from kbslam.io.checkpoint import save_checkpoint as jsave
    from kbslam.pipeline import init_state as jinit
    from kbslam_torch import config as tconfig
    from kbslam_torch.io.checkpoint import (load_checkpoint_meta,
                                            load_checkpoint_tsdf,
                                            save_checkpoint)
    from kbslam_torch.pipeline import init_state

    ckpt = tmp_path / "c.npz"
    base = ["--width", "160", "--height", "120", "--ba", "off", "--dense",
            "--eval"]
    s1 = _cli(base + ["--frames", "12", "--save-checkpoint", str(ckpt)])
    cfg = tconfig.DEFAULT_CONFIG.replace(image_height=120, image_width=160)
    cfg = cfg.replace(dense=dataclasses.replace(cfg.dense, enabled=True))
    vol = load_checkpoint_tsdf(str(ckpt), cfg, "cpu")
    assert int((vol.weight > 0).sum()) == s1["tsdf_observed_voxels"]
    meta = load_checkpoint_meta(str(ckpt))
    assert meta["render_consistency_coverage"] == \
        s1["render_consistency"]["coverage"]
    s2 = _cli(base + ["--frames", "4", "--resume", str(ckpt)])
    assert s2["tsdf_observed_voxels"] >= s1["tsdf_observed_voxels"]
    s3 = _cli(base + ["--frames", "4", "--resume", str(ckpt), "--chunk", "4"])
    assert s3["tsdf_observed_voxels"] >= s1["tsdf_observed_voxels"]

    # the JAX package's checkpoint of a volume, read by the port, and the
    # port's read back bit for bit
    rng = np.random.default_rng(0)
    jvol = jdense.TSDFState(
        tsdf=jnp.asarray(rng.uniform(-1, 1, cfg.dense.dims), jnp.float32),
        weight=jnp.asarray(rng.integers(0, 5, cfg.dense.dims), jnp.float32))
    jpath = tmp_path / "j.npz"
    jcfg = _cfg240().replace(image_height=120, image_width=160)
    jsave(str(jpath), jinit(jcfg), tsdf=jvol)
    got = load_checkpoint_tsdf(str(jpath), cfg, "cpu")
    np.testing.assert_array_equal(got.tsdf.numpy(), np.asarray(jvol.tsdf))
    np.testing.assert_array_equal(got.weight.numpy(), np.asarray(jvol.weight))
    tpath = tmp_path / "t.npz"
    save_checkpoint(str(tpath), init_state(cfg, "cpu"), tsdf=got)
    back = load_checkpoint_tsdf(str(tpath), cfg, "cpu")
    assert torch.equal(back.tsdf, got.tsdf)
    assert torch.equal(back.weight, got.weight)
    small = cfg.replace(dense=dataclasses.replace(cfg.dense, dims=(8, 8, 8)))
    with pytest.raises(ValueError):
        load_checkpoint_tsdf(str(tpath), small, "cpu")
