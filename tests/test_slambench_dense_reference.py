"""The port's submap fusion, slot choice and atlas ICP against the
benchmark's plain reference (``slambench/reference/mapping``), on the
CPU at a small grid (48 x 48 x 28 voxels of 10 cm, 3 slots), from the
spheres scene's seeded depth images and poses; and the dense
configuration's JSON lists arriving as tuples. No JAX:

    python -m pytest tests/test_slambench_dense_reference.py -q

Tolerances: weights equal, and tsdf within 1e-6 over the voxels the
check's rounding-edge rule keeps (projection 1e-3 px or more from a .5
edge) and over at least 99.9% of all voxels; a slab-wise fusion
bit-equal to the whole; ICP pose within 0.1 mm and 0.01 deg, RMSE within
1e-6 m, ``num_valid`` within 0.5% and the shell's acceptance alike; slot
windows equal and their anchor poses bit-equal.
"""
import functools
import json
import sys
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest
import torch

from kbslam_torch import config as C
from kbslam_torch.geom.camera import Intrinsics
from kbslam_torch.geom.se3 import SE3
from kbslam_torch.io.synthetic import render_sequence
from kbslam_torch.mapping import icp as picp
from kbslam_torch.mapping import submap as psub
from kbslam_torch.slam import anchor_pose_now, pose_T

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from slambench.harness import compare_dense  # noqa: E402
from slambench.reference.geom.camera import Intrinsics as RIntr  # noqa: E402
from slambench.reference.mapping import dense as rdense  # noqa: E402
from slambench.reference.mapping import icp as ricp  # noqa: E402
from slambench.reference.mapping import submap as rsub  # noqa: E402

torch.set_num_threads(1)

TSDF_TOL = 1e-6
MIN_AGREE = 0.999
POSE_M = 1e-4
POSE_DEG = 0.01
RMSE_M = 1e-6
VALID_SHARE = 0.005
SCALE = 0.001
CFG = C.DenseMapConfig(enabled=True, voxel_size=0.1, dims=(48, 48, 28),
                       origin=(-2.4, -2.4, 0.6), truncation=0.3,
                       submap_every=4, max_submaps=3)
# keyframe frames and the frames each submap's anchor is: one submap
# anchored at frame 2 fused from frames 0-3, one at 6 from 4-7, one at
# 10 from 8-11
ANCHORS = {0: 2, 4: 6, 8: 10}


class Ring(NamedTuple):
    """The map ring fields the slot logic reads."""

    kf_id: torch.Tensor
    kf_q: torch.Tensor
    kf_t: torch.Tensor


@functools.lru_cache(maxsize=1)
def _scene():
    seq = render_sequence(num_frames=12, height=120, width=160,
                          scene="spheres", seed=3)
    return seq, Intrinsics.from_matrix(seq.K), RIntr.from_matrix(seq.K)


def _qt(i, moved=None):
    """float32 (q, t) of frame i's pose, moved by ``moved`` (xi) first."""
    T = SE3.from_matrix(torch.as_tensor(_scene()[0].poses[i],
                                        dtype=torch.float32))
    if moved is not None:
        T = (SE3.exp(torch.tensor(moved, dtype=torch.float32)) @ T)
    T = T.normalize()
    return T.q.contiguous(), T.t.contiguous()


def _ring(live_moved: bool):
    """An 8-keyframe ring holding keyframes 2 and 6 (10's slot holds 2,
    so keyframe 10 reads its stored anchor); with ``live_moved`` their
    ring poses are moved off the anchors (a correction)."""
    ids = torch.tensor([-1, -1, 2, -1, -1, -1, 6, -1], dtype=torch.int32)
    q = torch.zeros(8, 4)
    q[:, 0] = 1.0
    t = torch.zeros(8, 3)
    for slot, f in ((2, 2), (6, 6)):
        q[slot], t[slot] = _qt(f, [0.01, -0.02, 0.005, 0.01, 0.0, -0.01]
                               if live_moved else None)
    return Ring(ids, q, t)


def _depth_raw(i):
    return torch.from_numpy(_scene()[0].depth[i].astype(np.int32))


@functools.lru_cache(maxsize=2)
def _fused(live_moved: bool):
    """Both packages' atlases after every frame fused as a keyframe, and
    for each fusion the gap numbers (the share of voxels within
    ``TSDF_TOL``, the widest tsdf gap the rule keeps, weights equal)."""
    _, intr, rintr = _scene()
    ring = _ring(live_moved)
    start, fuse = psub.make_submap_ops(CFG, intr, CFG.max_submaps, SCALE)
    prog = psub.empty_atlas(CFG, CFG.max_submaps, "cpu")
    q0 = torch.zeros(3, 4)
    q0[:, 0] = 1.0
    ref = rsub.Atlas(0, CFG.max_submaps, q0, torch.zeros(3, 3),
                     torch.full((3,), -1, dtype=torch.int32), {})
    gaps = []
    for i in range(12):
        depth = _depth_raw(i)
        if i in ANCHORS:
            kid = ANCHORS[i]
            aq, at = _qt(kid)
            prog = prog._replace(count=prog.count + 1)
            slot = torch.tensor(prog.active_slot())
            start(prog, aq, at, torch.tensor(kid, dtype=torch.int32),
                  slot=slot)
            # the reference opens its submap at the anchor's pose too
            ref = ref._replace(count=ref.count + 1)
            s = ref.active_slot()
            ref.volumes[s] = rdense.empty_tsdf(CFG.dims, "cpu")
            ref.anchor_q[s], ref.anchor_t[s] = aq, at
            ref.anchor_kf_id[s] = kid
        slot = torch.tensor(prog.active_slot())
        q, t = _qt(i)
        fuse(prog, depth, q, t, *anchor_pose_now(prog, ring, slot),
             slot=slot)
        ref, s, local = rsub.fuse_keyframe(
            ref, 1, CFG.submap_every, -1, depth.to(torch.float32) * SCALE,
            q, t, ring, rintr, CFG)
        assert s == prog.active_slot()
        keep = compare_dense.keep_rule(
            CFG, rintr, depth.to(torch.float32) * SCALE, local,
            local)(0, CFG.dims[0])
        gap = (prog.tsdf[s].reshape(-1) - ref.volumes[s].tsdf.reshape(-1))
        gaps.append((float((gap.abs() <= TSDF_TOL).float().mean()),
                     float(gap.abs()[keep].max()),
                     bool(torch.equal(prog.weight[s],
                                      ref.volumes[s].weight))))
    return prog, ref, gaps


@pytest.mark.parametrize("live_moved", [False, True])
def test_slot_fusion_matches_reference(live_moved):
    """Twelve keyframes fused into three submaps, each anchored at a
    keyframe whose ring pose is its anchor pose (or moved by a correction,
    which the fusion follows); keyframe 10's ring slot was reallocated, so
    its submap reads the stored anchor."""
    prog, ref, gaps = _fused(live_moved)
    for agree, gap, same_w in gaps:
        assert agree >= MIN_AGREE and gap <= TSDF_TOL and same_w, gaps
    for s in range(CFG.max_submaps):
        assert float(prog.weight[s].max()) == 4.0
        torch.testing.assert_close(prog.anchor_q[s], ref.anchor_q[s],
                                   rtol=0, atol=1e-6)
        torch.testing.assert_close(prog.anchor_t[s], ref.anchor_t[s],
                                   rtol=0, atol=1e-6)
    assert torch.equal(prog.anchor_kf_id, ref.anchor_kf_id)


def test_slab_fusion_equals_the_whole():
    """The reference fused 5 x rows at a time (the last slab short) equals
    the whole slot fused at once, bit for bit."""
    _, _, rintr = _scene()
    _, ref, _ = _fused(False)
    depth = _depth_raw(9).to(torch.float32) * SCALE
    q, t = _qt(9)
    whole, _, _ = rsub.fuse_keyframe(ref, 1, CFG.submap_every, -1, depth, q,
                                     t, _ring(False), rintr, CFG)
    slabs, s, _ = rsub.fuse_keyframe(ref, 1, CFG.submap_every, -1, depth, q,
                                     t, _ring(False), rintr, CFG, slab=5)
    assert torch.equal(whole.volumes[s].tsdf, slabs.volumes[s].tsdf)
    assert torch.equal(whole.volumes[s].weight, slabs.volumes[s].weight)


@pytest.mark.parametrize("exclude_active", [False, True])
@pytest.mark.parametrize("k", [2, 3])
def test_slot_window_matches_reference(exclude_active, k):
    """The ICP window: newest first, the active submap left out in
    refine, a short window padded with its last entry, each anchor at its
    ring pose or, reallocated, its stored pose."""
    prog, ref, _ = _fused(True)
    ring = _ring(True)
    p = psub.recent_slots_with_poses(prog, ring, k, exclude_active)
    r = rsub.recent_slots_with_poses(ref, ring, k, exclude_active)
    assert p[0].tolist() == r[0]
    assert np.array_equal(p[1], r[1].numpy())
    assert np.array_equal(p[2], r[2].numpy())


def _host_accepted(v, icp, refine):
    """The shell's gates on an ICP result vector (``slam._icp_tick``)."""
    n, rmse_init, rmse = int(v[7]), v[8], v[9]
    ok = bool(n >= icp.min_points and rmse <= icp.accept_rmse_m
              and rmse <= rmse_init)
    return ok and bool(rmse < rmse_init) if refine else ok


@pytest.mark.parametrize("frame,exclude_active,slots",
                         [(5, False, [2, 1, 0]), (9, True, [1, 0, 0])])
def test_atlas_icp_matches_reference(frame, exclude_active, slots):
    """ICP from a pose 2-4 cm and about a degree off, against the window
    the shell would hand it (refine's, without the active submap, padded
    when short), anchors corrected."""
    from kbslam_torch.slam import _icp_vector

    _, intr, rintr = _scene()
    prog, ref, _ = _fused(True)
    icp = C.DenseIcpConfig(mode="refine", iters=10, atlas_slots=3)
    win = psub.recent_slots_with_poses(prog, _ring(True), 3, exclude_active)
    assert win[0].tolist() == slots
    aq, at = torch.from_numpy(win[1]), torch.from_numpy(win[2])
    q0, t0 = _qt(frame, [0.025, -0.02, 0.02, 0.012, -0.015, 0.010])
    depth = _depth_raw(frame)
    p = picp.make_icp_atlas(CFG, icp, intr, SCALE)(
        prog, torch.from_numpy(win[0]), aq, at, depth, q0, t0)
    r = ricp.align_depth_to_atlas(
        [ref.volumes[s] for s in win[0].tolist()], aq, at,
        depth.to(torch.float32) * SCALE, q0, t0, rintr, CFG, icp)
    dT = np.linalg.inv(pose_T(r.q, r.t)) @ pose_T(p.q, p.t)
    ang = np.degrees(np.arccos(np.clip((np.trace(dT[:3, :3]) - 1) / 2,
                                       -1, 1)))
    assert np.linalg.norm(dT[:3, 3]) <= POSE_M and ang <= POSE_DEG
    assert abs(float(p.rmse) - float(r.rmse)) <= RMSE_M
    assert abs(float(p.rmse_init) - float(r.rmse_init)) <= RMSE_M
    assert abs(int(p.num_valid) - int(r.num_valid)) \
        <= VALID_SHARE * int(r.num_valid)
    assert int(r.num_valid) > 300 and float(r.rmse) < float(r.rmse_init)
    v = _icp_vector(p).numpy()
    for refine in (False, True):
        assert _host_accepted(v, icp, refine) == ricp.accepted(r, icp,
                                                               refine)
    # the refined pose lands nearer the truth than the start
    e0 = np.linalg.norm(pose_T(q0, t0)[:3, 3] - pose_T(*_qt(frame))[:3, 3])
    e1 = np.linalg.norm(pose_T(r.q, r.t)[:3, 3] - pose_T(*_qt(frame))[:3, 3])
    assert e1 < e0, (e0, e1)


def test_the_dense_configuration_arrives_as_tuples():
    """``replay.dense_config`` turns the JSON lists of the configuration's
    dense section into tuples, so the frozen configuration keys the
    programs' caches, in the program and in the reference alike; the
    lists as they come would not."""
    from slambench.harness import manifest
    from slambench.harness.setup import slam_config
    from slambench.reference import config as rconfig

    replay = manifest.load_module("drivers", "replay")
    cell = manifest.load_cell("desk-dense512-replay")
    slam = json.loads(json.dumps(cell.config["slam"]))
    assert isinstance(slam["dense"]["dims"], list)
    for module in (C, rconfig):
        cfg = replay.dense_config(module, slam)
        assert cfg.dense.dims == (512, 512, 512)
        assert cfg.dense.origin == (-1.5, -1.5, 1.0)
        assert cfg.dense.voxel_size * 512 == 3.0
        assert cfg.dense_icp.mode == "refine" and hash(cfg) is not None
    cfg = replay.dense_config(C, slam)
    intr = Intrinsics.from_matrix(np.array([[517.3, 0, 319.5],
                                            [0, 517.3, 239.5], [0, 0, 1]]))
    psub.make_submap_ops(cfg.dense, intr, cfg.dense.max_submaps, SCALE)
    picp.make_icp_atlas(cfg.dense, cfg.dense_icp, intr, SCALE)
    raw = slam_config(C, slam)
    with pytest.raises(TypeError):
        psub.make_submap_ops(raw.dense, intr, raw.dense.max_submaps, SCALE)
