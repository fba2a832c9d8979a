"""The per-frame shell's in-place programs against a drive of the eager
functions (the CPU counterpart of the card's CUDA graphs).

``kbslam_torch.slam.SLAM`` keeps one live state and writes every
program's result into its tensors in place; on CUDA each program is a
replayed CUDA graph on those tensors. ``eager_drive`` runs the same
frames through the functions the programs are made of
(``make_track_step``, ``local_ba``, ``make_cull``, ``make_reloc_step``,
the dense and ICP factories, the loop runner), rebinding each new state
as the shell did before it wrote in place: the shell must equal it
exactly. On the card, tests/test_torch_cuda.py holds the graphed shell
against ``EagerSLAM``, the same shell with its programs called eagerly.
This file imports no JAX:

    python -m pytest tests/test_torch_slam_graph.py -q
"""
import numpy as np
import pytest
import torch

from kbslam_torch import config as C
from kbslam_torch.device import LiveGraphs, tensor_leaves
from kbslam_torch.io.synthetic import render_sequence
from kbslam_torch.pipeline import clone_state
from kbslam_torch.slam import SLAM

torch.set_num_threads(1)

DIAG_KEYS = ("frame", "success", "added_kf", "ran_ba", "inlier_ratio",
             "num_matches", "num_inliers", "num_features")


def eager_drive(cfg, K, rgbs, depths, masks=None, *, ba_mode="on_keyframe",
                use_mask=True, seed=0, rewind=None):
    """``SLAM.process`` over the frames, with each program called eagerly
    and its new state rebound, not written back: the yardstick of the
    shell's in-place programs and their CUDA graphs. ``ba_mode`` is
    "on_keyframe" or "disabled". ``rewind=(a, b)`` saves a copy of the
    state before frame ``a`` and resumes from it before frame ``b`` (the
    shell's ``state`` setter). Returns the frame poses, diagnostics and
    solve records (without their wall times), the event lists, and the
    final state and dense model."""
    from kbslam_torch.ba.local_ba import local_ba, stats_record, stats_vector
    from kbslam_torch.geom.camera import Intrinsics
    from kbslam_torch.loop.reloc import make_reloc_step
    from kbslam_torch.loop.runner import LoopCloser
    from kbslam_torch.mapping import dense, icp, submap
    from kbslam_torch.mapping.cull import make_cull
    from kbslam_torch.pipeline import init_state, make_track_step
    from kbslam_torch.slam import (anchor_pose_now, output_to_host, pose_T,
                                   reloc_to_host)

    if ba_mode not in ("on_keyframe", "disabled"):
        raise ValueError(ba_mode)
    dev = torch.device("cpu")
    intr = Intrinsics.from_matrix(K)
    lc, d, icfg = cfg.loop, cfg.dense, cfg.dense_icp
    scale = cfg.map.depth_scale
    step = make_track_step(cfg, intr, use_mask=use_mask, seed=seed)
    cull = make_cull(cfg.cull) if cfg.cull.enabled else None
    loop = LoopCloser(cfg, intr) if lc.enabled else None
    reloc = (make_reloc_step(cfg, intr, use_mask=use_mask,
                             word_bits=lc.word_bits,
                             score_min=lc.reloc_score_min,
                             min_inliers=lc.reloc_min_inliers, seed=seed)
             if lc.reloc_after > 0 else None)
    state = init_state(cfg, dev)
    tsdf = atlas = None
    if d.enabled and d.submap_every > 0:
        atlas = submap.empty_atlas(d, d.max_submaps, dev)
        start, fuse = submap.make_submap_ops(d, intr, d.max_submaps, scale)
        run_icp = icp.make_icp_atlas(d, icfg, intr, scale)
    elif d.enabled:
        tsdf = dense.empty_tsdf(d, dev)
        integrate = dense.make_integrate(d, intr, scale)
        run_icp = icp.make_icp(d, icfg, intr, scale)

    def up(a, dtype=None):
        return torch.from_numpy(np.array(a, dtype)).to(dev)

    res = dict(poses=[], diagnostics=[], ba_stats=[], reloc_events=[],
               icp_events=[])
    streak = tracked_kf = num_kf = kf_ins = 0
    last_icp, saved = None, None
    for i in range(len(rgbs)):
        if rewind is not None and i == rewind[0]:
            saved = clone_state(state)
        if rewind is not None and i == rewind[1]:
            state = saved
            tracked_kf = num_kf = int(state.map.num_kf)
            if loop is not None:
                loop.start_at(tracked_kf)
        rgb, depth = up(rgbs[i], np.uint8), up(depths[i], np.int32)
        mask = None
        if use_mask:
            mask = (up(masks[i]) if masks is not None and masks[i] is not None
                    else torch.ones(rgb.shape[:2], dtype=torch.uint8,
                                    device=dev))
        state, out = step(state, rgb, depth, mask)
        o = output_to_host(out)
        if cull is not None and o["added_kf"]:
            state = state._replace(map=cull(state.map))
        ran_ba = False
        if ba_mode == "on_keyframe" and o["added_kf"]:
            m, stats = local_ba(state.map, intr, cfg.ba)
            state = state._replace(map=m)
            res["ba_stats"].append(stats_record(
                stats_vector(stats).cpu().numpy()))
            ran_ba = True
        inserted = int(bool(o["added_kf"]))
        if reloc is not None:                          # _reloc_tick
            if o["success"]:
                tracked_kf = int(o["anchor_id"]) + 1
            if o["success"] or o["anchor_id"] < 0:
                streak = 0
            else:
                streak += 1
                if streak >= lc.reloc_after:
                    state, r = reloc(state, rgb, depth, mask,
                                     exclude_from_id=tracked_kf)
                    rr = reloc_to_host(r, state.map)
                    if rr["success"]:
                        streak, tracked_kf = 0, rr["num_kf"]
                        res["reloc_events"].append(dict(
                            frame=i, matched_id=rr["matched_id"],
                            score=rr["score"], inliers=rr["inliers"]))
                        o = dict(o, success=True, added_kf=True,
                                 relocalized=True, pose_q=rr["pose_q"],
                                 pose_t=rr["pose_t"],
                                 num_inliers=rr["inliers"],
                                 anchor_id=rr["num_kf"] - 1,
                                 anchor_q=rr["pose_q"], anchor_t=rr["pose_t"])
                        inserted += 1
        num_kf += inserted
        if icfg.mode != "off":                         # _icp_tick
            ok = bool(o["success"])
            q0 = t0 = None
            if ok:
                last_icp = None
                if icfg.mode == "refine" and not o["added_kf"]:
                    q0, t0 = o["pose_q"], o["pose_t"]
            elif last_icp is not None:
                q0, t0 = last_icp
            else:
                q0, t0 = o["pose_q"], o["pose_t"]
            r = None
            if q0 is not None:
                q0, t0 = up(q0, np.float32), up(t0, np.float32)
                if atlas is None:
                    r = run_icp(tsdf, depth, q0, t0)
                else:
                    win = submap.recent_slots_with_poses(
                        atlas, state.map, icfg.atlas_slots,
                        exclude_active=ok)
                    if win is not None:
                        r = run_icp(atlas, *(up(a) for a in win), depth,
                                    q0, t0)
            if r is not None:
                v = torch.cat([r.q, r.t, torch.stack([
                    r.num_valid.to(r.q.dtype), r.rmse_init, r.rmse])]
                    ).cpu().numpy()
                q, t, n, r0, r1 = v[:4], v[4:7], int(v[7]), v[8], v[9]
                acc = bool(n >= icfg.min_points and r1 <= icfg.accept_rmse_m
                           and r1 <= r0)
                if ok:
                    acc = acc and bool(r1 < r0)
                res["icp_events"].append(dict(
                    frame=i, mode="refine" if ok else "rescue", accepted=acc,
                    num_valid=n, rmse_init=float(r0), rmse=float(r1)))
                if acc:
                    if not ok:
                        last_icp = (q, t)
                    o = dict(o, success=True, pose_q=q, pose_t=t)
        if d.enabled and o["added_kf"]:                # _fuse
            q, t = up(o["pose_q"], np.float32), up(o["pose_t"], np.float32)
            if atlas is None:
                tsdf = integrate(tsdf, depth, q, t)
            else:
                if kf_ins % d.submap_every == 0:
                    atlas = start(atlas, q, t, num_kf - 1)
                atlas = fuse(atlas, depth, q, t,
                             *anchor_pose_now(atlas, state.map))
                kf_ins += 1
        if loop is not None:
            if inserted:
                loop.note_insertions(inserted)
            state = loop.tick(state, i, None)
        res["poses"].append(pose_T(o["pose_q"], o["pose_t"]))
        res["diagnostics"].append(dict(
            frame=i, success=bool(o["success"]), added_kf=bool(o["added_kf"]),
            ran_ba=ran_ba, inlier_ratio=float(o["inlier_ratio"]),
            num_matches=int(o["num_matches"]),
            num_inliers=int(o["num_inliers"]),
            num_features=int(o["num_features"])))
    res["loop_events"] = loop.events if loop is not None else []
    res["state"], res["tsdf"], res["atlas"] = state, tsdf, atlas
    return res


class EagerSLAM(SLAM):
    """The shell with every program called eagerly, on any device: the
    yardstick of its CUDA graphs on the card."""

    def _program(self, name, fn):
        return fn


def run_record(slam) -> dict:
    """A shell run in ``eager_drive``'s form (``assert_shell_equals_drive``
    compares two shells this way)."""
    return dict(poses=slam.frame_poses,
                diagnostics=[{k: d[k] for k in DIAG_KEYS}
                             for d in slam.diagnostics],
                ba_stats=slam.ba_stats, reloc_events=slam.reloc_events,
                icp_events=slam.icp_events, loop_events=slam.loop_events,
                state=slam.state, tsdf=slam.tsdf, atlas=slam.atlas)


def shell_run(slam, rgbs, depths, masks=None, rewind=None, on_frame=None):
    """``slam`` after processing the frames, with ``eager_drive``'s
    ``rewind`` through the ``state`` setter; ``on_frame(slam)`` runs after
    every frame."""
    saved = None
    for i in range(len(rgbs)):
        if rewind is not None and i == rewind[0]:
            saved = clone_state(slam.state)
        if rewind is not None and i == rewind[1]:
            slam.state = saved
        slam.process(rgbs[i], depths[i], None if masks is None else masks[i])
        if on_frame is not None:
            on_frame(slam)
    return slam


def assert_shell_equals_drive(slam, ref):
    """Bit-equality of a shell run and an ``eager_drive`` run: frame
    poses, diagnostics, solve stats, events, state and dense model."""
    assert len(slam.frame_poses) == len(ref["poses"])
    for i, (a, b) in enumerate(zip(slam.frame_poses, ref["poses"])):
        assert np.array_equal(a, b), f"frame {i}: pose {a} != {b}"
    got = [{k: d[k] for k in DIAG_KEYS} for d in slam.diagnostics]
    assert got == ref["diagnostics"]
    def no_wall(stats):
        return [{k: v for k, v in s.items() if k != "wall_ms"}
                for s in stats]

    assert no_wall(slam.ba_stats) == no_wall(ref["ba_stats"])
    assert slam.reloc_events == ref["reloc_events"]
    assert slam.loop_events == ref["loop_events"]
    assert slam.icp_events == ref["icp_events"]
    for name, a, b in (("state", slam.state, ref["state"]),
                       ("tsdf", slam.tsdf, ref["tsdf"]),
                       ("atlas", slam.atlas, ref["atlas"])):
        la, lb = list(tensor_leaves(a)), list(tensor_leaves(b))
        assert len(la) == len(lb), name
        for k, (x, y) in enumerate(zip(la, lb)):
            assert torch.equal(x.cpu(), y.cpu()), f"{name} tensor {k}"
    if ref["atlas"] is not None:
        assert slam.atlas.count == ref["atlas"].count


# --- the lost-and-found scene with every per-frame program ---------------

def lost_and_found(T_back=8, height=240, width=320):
    """tests/test_loop.py:277-295 at 240x320: pan away, three blank
    frames, pan back."""
    from scipy.spatial.transform import Rotation

    def pan(T):
        out = []
        for i in range(T):
            s = i / max(T - 1, 1)
            P = np.eye(4)
            P[:3, :3] = Rotation.from_rotvec([0, 0.55 * s, 0]).as_matrix()
            P[:3, 3] = [2.2 * s, 0.0, -2.5]
            out.append(P)
        return np.stack(out)

    poses = np.concatenate([pan(22), pan(22)[:3], pan(22)[:T_back]])
    seq = render_sequence(num_frames=len(poses), height=height, width=width,
                          fx=260.0 * width / 320, scene="spheres", seed=2,
                          poses=poses)
    rgb, dep = seq.rgb.copy(), seq.depth.copy()
    rgb[22:25] = 0
    dep[22:25] = 0
    return seq.K, rgb, dep


def every_program_cfg(height=240, width=320, submaps=0, icp="rescue"):
    """tests/test_loop.py:298-306's relocalization settings with a small
    ring, culling, loop closure, the dense model (the volume, or an atlas
    of ``submaps`` submaps) and dense ICP."""
    import dataclasses

    cfg = C.SLAMConfig(
        image_height=height, image_width=width,
        orb=C.OrbConfig(num_features=512, num_levels=4, max_features=512),
        pnp=C.PnPConfig(num_hypotheses=128),
        policy=C.KeyframePolicyConfig(min_frame_gap=4),
        map=C.MapConfig(max_keyframes=8, max_map_points=4096),
        ba=C.BAConfig(window=3, compact_obs=1024, compact_landmarks=1024,
                      max_iterations=5),
        loop=C.LoopConfig(enabled=True, reloc_after=2, reloc_score_min=0.4,
                          reloc_min_inliers=30, min_separation=3),
        dense=C.DenseMapConfig(enabled=True, submap_every=submaps,
                               max_submaps=max(submaps, 1) * 3),
        dense_icp=C.DenseIcpConfig(mode=icp))
    return cfg.replace(cull=dataclasses.replace(cfg.cull, enabled=True,
                                                min_keep=3))


@pytest.fixture(scope="module")
def every_program_run():
    """The shell over the lost-and-found frames with every program on,
    rewound by five frames through the ``state`` setter at frame 30, its
    tensors' addresses recorded after every frame; and the eager drive of
    the same frames."""
    K, rgb, dep = lost_and_found()
    cfg = every_program_cfg()
    slam = SLAM(cfg, K, device="cpu")
    ptrs = []

    def record(s):
        ptrs.append([t.data_ptr() for t in tensor_leaves((s.state, s.tsdf))])

    record(slam)
    shell_run(slam, rgb, dep, rewind=(25, 30), on_frame=record)
    ref = eager_drive(cfg, K, rgb, dep, rewind=(25, 30))
    return slam, ref, ptrs, cfg, (K, rgb, dep)


def test_shell_keeps_its_live_tensors(every_program_run):
    """Every TrackState, MapState and volume tensor stays where it is
    across ``process`` calls and the resume: each program wrote in
    place."""
    slam, _, ptrs, _, _ = every_program_run
    assert len(ptrs) == len(slam.diagnostics) + 1
    assert all(p == ptrs[0] for p in ptrs)


def test_shell_equals_the_eager_drive(every_program_run):
    """The run reached every program, and its trajectory, diagnostics,
    solves, events, map and volume equal the eager drive's exactly."""
    slam, ref, _, _, _ = every_program_run
    assert slam.reloc_events, "relocalization never fired"
    assert slam.ba_stats and slam.icp_events
    assert_shell_equals_drive(slam, ref)


def test_reloc_with_a_device_exclusion_id_equals_the_host_int(
        every_program_run):
    """``make_reloc_step`` with ``exclude_from_id`` as a 0-d int32 tensor
    (what the shell loads before each replay) equals the host-int form,
    with an id that masks keyframes out and with one that does not."""
    from kbslam_torch.geom.camera import Intrinsics
    from kbslam_torch.loop.reloc import make_reloc_step

    slam, _, _, cfg, (K, rgb, dep) = every_program_run
    step = make_reloc_step(cfg, Intrinsics.from_matrix(K), use_mask=False,
                           score_min=0.0, min_inliers=0)
    frame = [torch.from_numpy(rgb[27]), torch.from_numpy(dep[27]
                                                        .astype(np.int32))]
    n = int(slam.state.map.num_kf)
    for exclude in (n - 3, n + 5):
        host = step(clone_state(slam.state), *frame, exclude_from_id=exclude)
        dev = step(clone_state(slam.state), *frame,
                   exclude_from_id=torch.tensor(exclude, dtype=torch.int32))
        for a, b in zip(tensor_leaves(host), tensor_leaves(dev)):
            assert torch.equal(a, b)


def test_state_setter_copies_and_checks_shapes(every_program_run):
    """The setter copies into the live tensors and raises on a state of
    another layout."""
    slam, _, _, cfg, (K, _, _) = every_program_run
    fresh = SLAM(cfg, K, device="cpu")
    before = [t.data_ptr() for t in tensor_leaves(fresh.state)]
    fresh.state = clone_state(slam.state)
    assert [t.data_ptr() for t in tensor_leaves(fresh.state)] == before
    for a, b in zip(tensor_leaves(fresh.state), tensor_leaves(slam.state)):
        assert torch.equal(a, b)
    other = SLAM(every_program_cfg().replace(
        map=C.MapConfig(max_keyframes=4, max_map_points=4096)), K,
        device="cpu")
    with pytest.raises(ValueError):
        fresh.state = other.state


# --- the atlas and ICP at 120x160 -----------------------------------------

def atlas_case():
    """(cfg, K, rgb, depth, masks): 16 frames of the 120x160 plane
    sequence into an atlas of a submap every two insertions, with BA on
    keyframe and the atlas ICP rescue through a two-frame mask blackout
    (as tests/test_dense_icp.py:118-163)."""
    seq = render_sequence(num_frames=16, height=120, width=160)
    masks = [None] * 16
    for i in (9, 10):
        masks[i] = np.zeros((120, 160), np.uint8)
    cfg = every_program_cfg(120, 160, submaps=2).replace(
        orb=C.OrbConfig(num_features=256, num_levels=3, max_features=256),
        policy=C.KeyframePolicyConfig(min_frame_gap=2,
                                      rotation_threshold_deg=2.0),
        loop=C.LoopConfig(enabled=False))
    return cfg, seq.K, seq.rgb, seq.depth, masks


def test_atlas_shell_equals_the_eager_drive():
    """The submap atlas's start and fuse and the atlas ICP rescue: the
    shell equals the eager drive exactly."""
    cfg, K, rgb, dep, masks = atlas_case()
    slam = shell_run(SLAM(cfg, K, device="cpu"), rgb, dep, masks)
    ref = eager_drive(cfg, K, rgb, dep, masks)
    assert slam.atlas.count >= 2 and slam.icp_events
    assert_shell_equals_drive(slam, ref)


def test_submap_ops_at_a_device_slot_equal_the_host_count():
    """``start_submap``, ``integrate_active`` (through ``make_submap_ops``)
    and ``slam.anchor_pose_now`` with the ring slot as a device tensor,
    as the shell's graphs take it, equal their host-count forms over a
    ring that wraps, anchors live and reallocated."""
    from kbslam_torch.geom.camera import Intrinsics
    from kbslam_torch.mapping import submap
    from kbslam_torch.pipeline import init_state
    from kbslam_torch.slam import anchor_pose_now

    cfg, K, rgb, dep, _ = atlas_case()
    d = cfg.dense
    start, fuse = submap.make_submap_ops(d, Intrinsics.from_matrix(K), 3,
                                         cfg.map.depth_scale)
    ring = init_state(cfg, "cpu").map
    ring.kf_id[:3] = torch.tensor([0, 1, 2], dtype=torch.int32)
    ring.kf_t[:3] = torch.tensor([[0.0, 0, 0.1], [0.02, 0, 0.1],
                                  [0.04, 0, 0.1]])
    host, dev = submap.empty_atlas(d, 3, "cpu"), submap.empty_atlas(d, 3,
                                                                     "cpu")
    for i in range(5):                          # slots 0, 1, 2, 0, 1
        q = torch.tensor([1.0, 0.0, 0.0, 0.0])
        t = torch.tensor([0.01 * i, 0.0, 0.0])
        host = start(host, q, t, i)
        dev = dev._replace(count=dev.count + 1)
        slot = torch.tensor(dev.active_slot())
        start(dev, q, t, torch.tensor(i, dtype=torch.int32), slot=slot)
        depth = torch.from_numpy(dep[i].astype(np.int32))
        pose_h = anchor_pose_now(host, ring)
        pose_d = anchor_pose_now(dev, ring, slot)
        assert all(torch.equal(a, b) for a, b in zip(pose_h, pose_d))
        fuse(host, depth, q, t, *pose_h)
        fuse(dev, depth, q, t, *pose_d, slot=slot)
        assert host.count == dev.count
        for a, b in zip(tensor_leaves(host), tensor_leaves(dev)):
            assert torch.equal(a, b)
    assert host.anchor_kf_id.tolist() == [3, 4, 2]


# --- the graphed wrappers refuse the CPU -----------------------------------

def _cpu_wrappers():
    from kbslam_torch.ba.local_ba import GraphedLocalBA
    from kbslam_torch.geom.camera import Intrinsics
    from kbslam_torch.pipeline import (init_state, make_track_step,
                                       track_step_into)

    cfg = every_program_cfg(120, 160)
    intr = Intrinsics.from_matrix(np.array([[100.0, 0, 80], [0, 100, 60],
                                            [0, 0, 1]]))
    state = init_state(cfg, "cpu")
    rgb = torch.zeros((120, 160, 3), dtype=torch.uint8)
    depth = torch.zeros((120, 160), dtype=torch.int32)
    return {
        "live_graphs": lambda: LiveGraphs(lambda x: x + 1)(torch.zeros(3)),
        "track_step": lambda: LiveGraphs(
            lambda *a: track_step_into(make_track_step(cfg, intr), *a),
            name="track")(state, rgb, depth, None),
        "local_ba": lambda: GraphedLocalBA(cfg.ba, intr, state.map),
    }


@pytest.mark.parametrize("name", ["live_graphs", "track_step", "local_ba"])
def test_graphed_wrappers_raise_on_the_cpu(name):
    with pytest.raises(ValueError):
        _cpu_wrappers()[name]()
