"""The port's submap atlas against kbslam/mapping/submap.py.

The module cases of tests/test_submap.py, each fed to both packages from
the same numpy inputs (depth rendered by ``render_sequence`` from its
seed, atlases and map rings as arrays):

- ``start_submap`` and ``integrate_active`` on one atlas, from a
  non-identity anchor, and the anchors, ids and count they leave;
- an identity anchor gives the monolithic volume;
- a correction handed to extraction moves the submap rigidly;
- ring overwrite and ``live_slots``;
- ``recent_slots_with_poses``, with padding, ``exclude_active`` and a
  reallocated ring slot;
- ``extract_atlas_surface`` and ``atlas_mesh``;
- the chunked stream's ``_fusion_poses_now`` bound, and a correction in
  the middle of a submap (tests/test_submap.py:264-310, 417-472).

Tolerances against JAX: slot ids, kf ids, counts, live and recent slots
exact; weights equal and tsdf within 1e-6 by the rule of
tests/test_torch_dense.py (every voxel whose projection, recomputed in
float64 at the fused anchor-local pose, lies 1e-3 px or more from a .5
rounding edge, and >= 99.9% of all voxels); anchor poses within 1e-6 (the
local pose ``anchor^-1 @ frame`` is composed in float32 by each package);
ring poses picked by ``recent_slots_with_poses`` bit-equal; extracted
points within 1e-5 m where both packages read the same atlas.
"""
import numpy as np
import jax.numpy as jnp
import torch

from kbslam.config import DenseMapConfig
from kbslam.geom.camera import Intrinsics as JIntr
from kbslam.io.synthetic import render_sequence
from kbslam.mapping import submap as jsub
from kbslam.mapping.mesh import marching_tetrahedra
from kbslam.pipeline import init_state as j_init
from kbslam_torch import convert
from kbslam_torch.geom.camera import Intrinsics as TIntr
from kbslam_torch.geom.se3 import SE3 as TSE3
from kbslam_torch.mapping import dense as tdense
from kbslam_torch.mapping import submap as tsub
from test_torch_dense import TSDF_TOL, MIN_AGREE, near_round_edge

torch.set_num_threads(1)

POSE_TOL = 1e-6


def _scene(T):
    seq = render_sequence(num_frames=T, height=120, width=160,
                          scene="spheres")
    return seq, JIntr.from_matrix(seq.K), TIntr.from_matrix(seq.K)


def _qt(T):
    """float32 (q, t) of a 4x4 pose."""
    T = np.asarray(T, np.float32)
    return (tdense._rot_to_quat(T[:3, :3]).astype(np.float32),
            np.ascontiguousarray(T[:3, 3]))


def _mat(q, t):
    from kbslam_torch.slam import pose_T
    return pose_T(q, t)


def _depth(seq, i):
    return seq.depth[i].astype(np.float32) * 0.001


def _jatlas(a):
    return jsub.SubmapAtlas(*(jnp.asarray(x) for x in a))


def assert_atlas_close(t_atlas, j_atlas, cfg, intr, local_poses):
    """Slot by slot at the module docstring's tolerance; ``local_poses``
    maps a slot to the (q, t) anchor-local poses fused into it."""
    t = convert.atlas_to_numpy(t_atlas)
    assert int(t.count) == int(j_atlas.count)
    np.testing.assert_array_equal(t.anchor_kf_id,
                                  np.asarray(j_atlas.anchor_kf_id))
    np.testing.assert_allclose(t.anchor_q, np.asarray(j_atlas.anchor_q),
                               atol=POSE_TOL)
    np.testing.assert_allclose(t.anchor_t, np.asarray(j_atlas.anchor_t),
                               atol=POSE_TOL)
    for s in range(t.tsdf.shape[0]):
        tw = t.weight[s].reshape(-1)
        jw = np.asarray(j_atlas.weight[s]).reshape(-1)
        tt = t.tsdf[s].reshape(-1)
        jt = np.asarray(j_atlas.tsdf[s]).reshape(-1)
        agree = (tw == jw) & (np.abs(tt - jt) <= TSDF_TOL)
        away = ~near_round_edge(cfg, intr, local_poses.get(s, []))
        assert agree[away].all(), (s, int((~agree & away).sum()))
        assert agree.mean() >= MIN_AGREE, (s, agree.mean())


def _local(A, P):
    """float64 anchor-local pose A^-1 P as (q, t) for the edge test."""
    L = np.linalg.inv(A) @ P
    return tdense._rot_to_quat(L[:3, :3]), L[:3, 3]


def test_start_and_integrate_match_reference():
    """Two submaps in a 3-slot ring, the first anchored at frame 0's
    ground-truth pose (not the identity), the second at frame 2's; each
    fuses two frames at the default (stored) anchor pose."""
    seq, ji, ti = _scene(4)
    cfg = DenseMapConfig(dims=(48, 48, 24), voxel_size=0.1,
                         origin=(-2.4, -2.4, 0.2))
    j = jsub.empty_atlas(cfg, 3)
    t = tsub.empty_atlas(cfg, 3, "cpu")
    local = {}
    for s, (anchor_i, frames) in enumerate(((0, (0, 1)), (2, (2, 3)))):
        qa, ta = _qt(seq.poses[anchor_i])
        j = jsub.start_submap(j, jnp.asarray(qa), jnp.asarray(ta),
                              kf_id=10 + anchor_i)
        t = tsub.start_submap(t, torch.from_numpy(qa), torch.from_numpy(ta),
                              kf_id=10 + anchor_i)
        for i in frames:
            q, tt = _qt(seq.poses[i])
            j = jsub.integrate_active(j, jnp.asarray(_depth(seq, i)),
                                      jnp.asarray(q), jnp.asarray(tt), ji, cfg)
            t = tsub.integrate_active(
                t, torch.from_numpy(_depth(seq, i)), torch.from_numpy(q),
                torch.from_numpy(tt), ti, cfg)
            local.setdefault(s, []).append(
                _local(_mat(qa, ta), _mat(q, tt)))
    assert t.count == 2 and t.active_slot() == 1
    assert_atlas_close(t, j, cfg, ti, local)
    assert float(t.weight[2].sum()) == 0 and float(t.weight[0].sum()) > 0


def test_identity_anchor_equals_monolithic():
    seq, _, ti = _scene(4)
    cfg = DenseMapConfig(dims=(48, 48, 24), voxel_size=0.17,
                         origin=(-4.08, -4.08, -1.36))
    atlas = tsub.start_submap(tsub.empty_atlas(cfg, 3, "cpu"),
                              torch.tensor([1.0, 0, 0, 0]), torch.zeros(3),
                              kf_id=0)
    mono = tdense.empty_tsdf(cfg, "cpu")
    for i in range(4):
        d = torch.from_numpy(_depth(seq, i))
        q, t = (torch.from_numpy(a) for a in _qt(seq.poses[i]))
        atlas = tsub.integrate_active(atlas, d, q, t, ti, cfg)
        mono = tdense.integrate(mono, d, TSE3(q, t), ti, cfg)
    s = atlas.active_slot()
    assert torch.equal(atlas.weight[s], mono.weight)
    assert float((atlas.tsdf[s] - mono.tsdf).abs().max()) <= TSDF_TOL


def _two_submaps(T=6):
    """A JAX atlas of two submaps (frames 0-2 anchored at frame 1, 3-5 at
    frame 4) on the 160x120 spheres, as numpy arrays."""
    seq, ji, _ = _scene(T)
    cfg = DenseMapConfig(dims=(48, 48, 28), voxel_size=0.1,
                         origin=(-2.4, -2.4, 0.2))
    a = jsub.empty_atlas(cfg, 3)
    for kid, frames in ((1, range(0, 3)), (4, range(3, 6))):
        qa, ta = _qt(seq.poses[kid])
        a = jsub.start_submap(a, jnp.asarray(qa), jnp.asarray(ta), kf_id=kid)
        for i in frames:
            q, t = _qt(seq.poses[i])
            a = jsub.integrate_active(a, jnp.asarray(_depth(seq, i)),
                                      jnp.asarray(q), jnp.asarray(t), ji, cfg)
    return seq, cfg, jsub.SubmapAtlas(*(np.asarray(x) for x in a))


def test_correction_reposes_submap_rigidly():
    seq, cfg, a = _two_submaps()
    t = convert.atlas_to_torch(a, "cpu")
    A = _mat(*_qt(seq.poses[4]))
    pts0, res0 = tsub.extract_atlas_surface(t, cfg, {4: A})
    assert pts0.shape[0] > 100
    frozen, _ = tsub.extract_atlas_surface(t, cfg, {})
    np.testing.assert_allclose(frozen, pts0, atol=1e-5)
    D = TSE3.exp(torch.tensor([0.3, -0.2, 0.1, 0.05, -0.04, 0.06],
                              dtype=torch.float64)).matrix().numpy()
    pts1, res1 = tsub.extract_atlas_surface(t, cfg, {4: D @ A})
    np.testing.assert_array_equal(res1, res0)
    # slot 0 (anchor 1, not handed in) comes first and stays put; slot 1
    # (anchor 4) moves by exactly D
    n0 = len(tsub.extract_atlas_surface(t._replace(count=1), cfg)[0])
    assert 0 < n0 < len(pts0)
    np.testing.assert_allclose(pts1[:n0], pts0[:n0], atol=1e-5)
    np.testing.assert_allclose(pts1[n0:], pts0[n0:] @ D[:3, :3].T + D[:3, 3],
                               atol=1e-4)


def test_ring_overwrite_and_live_slots():
    cfg = DenseMapConfig(dims=(8, 8, 8), voxel_size=0.2)
    j = jsub.empty_atlas(cfg, num_submaps=2)
    t = tsub.empty_atlas(cfg, 2, "cpu")
    # fuse something into slot 0 first, so the overwrite has to reset it
    t.weight[0].fill_(3.0)
    j = j._replace(weight=j.weight.at[0].set(3.0))
    for k in range(3):
        j = jsub.start_submap(j, jnp.array([1.0, 0, 0, 0]),
                              jnp.full(3, float(k)), kf_id=10 + k)
        t = tsub.start_submap(t, torch.tensor([1.0, 0, 0, 0]),
                              torch.full((3,), float(k)), kf_id=10 + k)
        np.testing.assert_array_equal(tsub.live_slots(t), jsub.live_slots(j))
    np.testing.assert_array_equal(tsub.live_slots(t), [1, 0])
    for a, b in zip(convert.atlas_to_numpy(t), j):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert t.anchor_kf_id.tolist() == [12, 11]
    assert float(t.weight[0].sum()) == 0.0


def _ring(n_kf, cap=4):
    """A JAX map ring after ``n_kf`` insertions into ``cap`` slots, with
    distinct poses, and the port's copy."""
    from kbslam.config import MapConfig, SLAMConfig

    m = j_init(SLAMConfig(map=MapConfig(max_keyframes=cap,
                                        max_map_points=64))).map
    rng = np.random.default_rng(n_kf)
    q = rng.normal(size=(cap, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    ids = np.full(cap, -1, np.int32)
    for k in range(n_kf):
        ids[k % cap] = k
    m = m._replace(kf_id=jnp.asarray(ids), kf_q=jnp.asarray(q),
                   kf_t=jnp.asarray(rng.normal(size=(cap, 3)), jnp.float32),
                   num_kf=jnp.int32(n_kf))
    return m, convert.map_to_torch(m, "cpu")


def test_recent_slots_with_poses_match_reference():
    """Three submaps in a 4-slot atlas anchored at keyframes 0, 3 and 5 of
    a 4-slot ring after 7 insertions: keyframe 0's ring slot was
    reallocated (its stored pose stands in), 3 and 5 are live."""
    cfg = DenseMapConfig(dims=(8, 8, 8), voxel_size=0.2)
    j = jsub.empty_atlas(cfg, 4)
    for k, kid in enumerate((0, 3, 5)):
        j = jsub.start_submap(j, jnp.array([0.8, 0.6, 0, 0]),
                              jnp.full(3, float(k)), kf_id=kid)
    t = convert.atlas_to_torch(jsub.SubmapAtlas(*(np.asarray(x) for x in j)),
                               "cpu")
    jm, tm = _ring(7)
    for k in (1, 2, 3, 5):
        for excl in (False, True):
            a = jsub.recent_slots_with_poses(j, jm, k, exclude_active=excl)
            b = tsub.recent_slots_with_poses(t, tm, k, exclude_active=excl)
            for x, y in zip(a, b):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
            assert len(b[0]) == k
    slots, q, _ = tsub.recent_slots_with_poses(t, tm, 5)
    assert slots.tolist() == [2, 1, 0, 0, 0]
    np.testing.assert_array_equal(q[2], np.float32([0.8, 0.6, 0, 0]))
    np.testing.assert_array_equal(q[0], tm.kf_q[5 % 4].numpy())
    one = tsub.start_submap(tsub.empty_atlas(cfg, 2, "cpu"),
                            torch.tensor([1.0, 0, 0, 0]), torch.zeros(3), 0)
    assert tsub.recent_slots_with_poses(one, tm, 2, exclude_active=True) \
        is None
    assert tsub.recent_slots_with_poses(tsub.empty_atlas(cfg, 2, "cpu"),
                                        tm, 2) is None
    assert tsub.anchor_poses_now(t, tm).keys() \
        == jsub.anchor_poses_now(j, jm).keys() == {3, 5}


def test_atlas_surface_and_mesh_match_reference():
    seq, cfg, a = _two_submaps()
    t = convert.atlas_to_torch(a, "cpu")
    j = _jatlas(a)
    D = np.eye(4)
    D[:3, 3] = [0.1, -0.2, 0.05]
    for poses in ({}, {4: D @ _mat(*_qt(seq.poses[4]))}):
        pt, rt = tsub.extract_atlas_surface(t, cfg, poses)
        pj, rj = jsub.extract_atlas_surface(j, cfg, poses)
        assert pt.shape == pj.shape and pt.shape[0] > 100
        np.testing.assert_array_equal(rt, rj)
        np.testing.assert_allclose(pt, pj, atol=1e-5)
        mt, mj = tsub.atlas_mesh(t, cfg, poses), jsub.atlas_mesh(j, cfg, poses)
        np.testing.assert_array_equal(mt.faces, mj.faces)
        np.testing.assert_array_equal(mt.vertices, mj.vertices)
        assert len(mt.faces) > 100
    one = marching_tetrahedra(jsub.TSDFState(a.tsdf[0], a.weight[0]), cfg)
    assert 0 < len(one.vertices) < len(mt.vertices)


def test_fusion_poses_bound_and_mid_submap_correction():
    """(a) ``ChunkedStream._fusion_poses_now`` (tests/test_submap.py:
    417-472): both poses from the live ring while no in-flight insertion
    can reach the anchor's slot, counted by insertions (a 10-frame gap
    keeps 64 frames in flight live), copies and not views; the drained
    pose and the stored anchor when the anchor's slot may have been
    reallocated. (b) A rigid correction D landing mid-submap, with the
    anchor's current pose D A handed to the fusion, leaves the chunk's
    local content as without it (tests/test_submap.py:264-310), in both
    packages, and stores D A as the anchor."""
    from types import SimpleNamespace

    from kbslam_torch.streaming import ChunkedStream

    cap = 64
    kf_q = torch.arange(cap * 4, dtype=torch.float32).reshape(cap, 4)
    kf_t = torch.arange(cap * 3, dtype=torch.float32).reshape(cap, 3)
    atlas = tsub.empty_atlas(DenseMapConfig(dims=(2, 2, 2)), 2, "cpu")
    atlas = tsub.start_submap(atlas, -torch.ones(4), -torch.ones(3), 3)

    def fpn(anchor, inflight, gap, kid):
        shell = SimpleNamespace(
            _active_anchor_kid=anchor, _fed=1000 + inflight, _frame=1000,
            _min_frame_gap=gap, _kf_cap=cap, atlas=atlas,
            _state=SimpleNamespace(map=SimpleNamespace(kf_q=kf_q,
                                                       kf_t=kf_t)))
        return ChunkedStream._fusion_poses_now(shell, kid, qd, td)

    qd, td = torch.full((4,), 99.0), torch.full((3,), 99.0)
    got = fpn(3, 64, 10, 5)
    for x, want in zip(got, (kf_q[5], kf_t[5], kf_q[3], kf_t[3])):
        assert torch.equal(x, want)
        assert x.data_ptr() not in (kf_q.data_ptr(), kf_t.data_ptr()) \
            and x._base is None                 # a copy, not a view
    for args in ((3, 64, 1, 5), (3, 0, 10, 3 + cap)):
        q, t, aq, at = fpn(*args)
        assert torch.equal(q, qd) and torch.equal(t, td)
        assert torch.equal(aq, atlas.anchor_q[0])
        assert torch.equal(at, atlas.anchor_t[0])

    seq, ji, ti = _scene(3)
    cfg = DenseMapConfig(dims=(48, 48, 28), voxel_size=0.1,
                         origin=(-2.4, -2.4, 0.2))
    A = _mat(*_qt(seq.poses[0]))
    D = TSE3.exp(torch.tensor([0.2, -0.1, 0.05, 0.03, -0.02, 0.04],
                              dtype=torch.float64)).matrix().numpy()
    out = {}
    for pkg in ("jax", "torch"):
        for corrected in (False, True):
            qa, ta = _qt(A)
            if pkg == "jax":
                a = jsub.start_submap(jsub.empty_atlas(cfg, 2), qa, ta, 7)
            else:
                a = tsub.start_submap(tsub.empty_atlas(cfg, 2, "cpu"),
                                      torch.from_numpy(qa),
                                      torch.from_numpy(ta), 7)
            for i in range(3):
                G = D if corrected and i == 2 else np.eye(4)
                q, t = _qt(G @ seq.poses[i])
                gq, gt = _qt(G @ A)
                if pkg == "jax":
                    a = jsub.integrate_active(
                        a, jnp.asarray(_depth(seq, i)), q, t, ji, cfg, gq, gt)
                else:
                    q, t, gq, gt = (torch.from_numpy(x)
                                    for x in (q, t, gq, gt))
                    a = tsub.integrate_active(
                        a, torch.from_numpy(_depth(seq, i)), q, t, ti, cfg,
                        gq, gt)
            out[pkg, corrected] = a
    for corrected in (False, True):
        assert_atlas_close(out["torch", corrected], out["jax", corrected],
                           cfg, ti, {0: [_local(A, P) for P in seq.poses]})
    ref, cor = out["torch", False], out["torch", True]
    dt = (cor.tsdf[0] - ref.tsdf[0]).abs()
    dw = (cor.weight[0] - ref.weight[0]).abs()
    assert float((dt > 2e-3).float().mean()) < 1e-3
    assert float((dw > 0).float().mean()) < 1e-3
    got = TSE3(cor.anchor_q[0].double(), cor.anchor_t[0].double()).matrix()
    np.testing.assert_allclose(got.numpy(), D @ A, atol=1e-5)
