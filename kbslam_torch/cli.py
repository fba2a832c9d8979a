"""Command-line entry point of the port: ``python -m kbslam_torch.cli``.

The port's counterpart of ``python -m kbslam.cli``, with the same flags,
validation errors and summary JSON keys (and ``--device``, ``--seed``):

- sources: ``synthetic`` (rendered RGB-D with ground truth, the default),
  ``tum:<dir>`` (a TUM RGB-D sequence directory) and ``zmq[:<endpoint>]``
  (a live camera manager over ZMQ, ``io/zmq_camera.py``; default endpoint
  ``tcp://localhost:5555``): the intrinsics handshake gives K, and its
  distortion when ``--dist`` is unset; the run ends at the publisher's
  end-of-stream marker, after ``--frames`` frames, or gracefully when the
  publisher stalls;
- per-frame tracking with local BA after each keyframe (``--ba on``, the
  default), asynchronous (``async``) or off;
- ``--chunk N``: the chunked streaming executor (``streaming.py``, one
  CUDA graph replay per N frames on the card), with ``--ba off`` or
  ``async`` and optional ``--gray`` ingress;
- ``--loop`` (loop closure), ``--reloc N`` (relocalization after N
  failures in a row) and ``--cull`` (keyframe culling), per frame and
  with ``--chunk``;
- ``--dense`` (keyframe depth fused into the monolithic TSDF volume, per
  frame and with ``--chunk``), ``--dense-submaps K`` (a submap atlas
  instead, a new submap every K keyframe insertions), ``--dense-icp
  {off,rescue,refine}`` (frame-to-model tracking, per frame only),
  ``--save-surface``, ``--save-mesh``;
- ``--global-ba``: one guarded global bundle adjustment over the whole
  keyframe ring at the end of the run (``ba/global_ba.py``), per frame
  and with ``--chunk``;
- ``--viewer rerun`` (``viz/rerun_viewer.py``; without the ``rerun`` SDK
  a recorder that logs nothing) and ``--viewer-every N``: the
  trajectory, keyframes, landmarks and the frame's images every N-th
  frame (every frame by default per frame, once per chunk with
  ``--chunk``); with ``--dense`` also the surface cloud and a stride-4
  render of the model on keyframe frames (at most once per N frames
  with ``--chunk``), and the mesh with ``--save-mesh``. The viewer only
  reads: the results equal those of ``--viewer none``;
- ``--mask``, ``--dist``, ``--depth-edge-rel``, ``--save-trajectory``,
  ``--save-checkpoint`` (with the volume or the atlas), ``--resume``
  (restores it) and ``--eval``;
- ``--trace DIR``: where the time goes. The run goes under
  ``utils.profiling.device_trace``, which writes ``DIR/trace.json`` (a
  Chrome trace in which the recorder's ``kbslam.*`` spans sit beside the
  kernels); the recorder's records go to ``DIR/spans.json``, and a table
  of its spans, device stages and counters (count, total, p50, max) to
  standard error.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np


def _frames(args, ap, dist):
    """(K, config, iterator of (rgb, depth, mask, T_wc or None), lens
    distortion): ``dist`` (from --dist), or for the zmq source the
    handshake's when ``dist`` is None and the handshake's is not zero."""
    from kbslam_torch.config import DEFAULT_CONFIG

    if args.source.startswith("tum:"):
        from kbslam_torch.io.tum import TUMDataset

        ds = TUMDataset(args.source[4:])
        cfg = DEFAULT_CONFIG.replace(map=dataclasses.replace(
            DEFAULT_CONFIG.map, depth_scale=ds.depth_scale))
        return ds.K, cfg, iter(ds), dist
    if args.source.startswith("zmq"):
        from kbslam_torch.io.zmq_camera import DEFAULT_ENDPOINT, ZMQCamera

        ep = args.source[4:] if ":" in args.source else DEFAULT_ENDPOINT
        cam = ZMQCamera(ep or DEFAULT_ENDPOINT)
        K, zmq_dist = cam.get_intrinsics()
        if dist is None and zmq_dist is not None and np.any(zmq_dist):
            dist = zmq_dist
        return K, DEFAULT_CONFIG, _camera_frames(cam), dist
    if args.source != "synthetic":
        ap.error(f"unknown --source {args.source!r} "
                 "(expected synthetic | tum:<dir> | zmq[:<endpoint>])")
    from kbslam_torch.io.synthetic import render_sequence

    seq = render_sequence(num_frames=args.frames, height=args.height,
                          width=args.width, fx=525.0 * args.width / 640.0)
    frames = ((seq.rgb[i], seq.depth[i], seq.mask[i], seq.poses[i])
              for i in range(len(seq.rgb)))
    return seq.K, DEFAULT_CONFIG, frames, dist


def _camera_frames(cam):
    """The camera's frames up to its end-of-stream marker. A publisher
    stall ends the stream too, so that what was tracked is still
    reported (the reference would block for good). The camera closes
    when the iterator ends or is dropped."""
    try:
        while True:
            try:
                f = cam.grab_frames()
            except TimeoutError as e:
                print(f"kbslam_torch: camera timeout ({e}); ending stream",
                      file=sys.stderr)
                return
            if f is None:
                return
            yield f[0], f[1], f[2], None
    finally:
        cam.close()


def _save_trajectory(path, est):
    from scipy.spatial.transform import Rotation

    with open(path, "w") as f:
        for i, T in enumerate(est):
            q = Rotation.from_matrix(T[:3, :3]).as_quat()
            f.write(f"{i} {T[0,3]} {T[1,3]} {T[2,3]} "
                    f"{q[0]} {q[1]} {q[2]} {q[3]}\n")


def _evaluate(summary, est, gts, refined):
    """ATE, RPE and (with BA) the refined trajectory's ATE."""
    from kbslam_torch.eval import trajectory

    gt = np.stack(gts)
    summary["ate_rmse_m"] = trajectory.ate_rmse(est[:, :3, 3], gt[:, :3, 3])
    if refined is not None:
        summary["ate_rmse_refined_m"] = trajectory.ate_rmse(
            refined[:, :3, 3], gt[:, :3, 3])
    t_err, r_err = trajectory.rpe(est, gt)
    summary["rpe_trans_m"] = t_err
    summary["rpe_rot_rad"] = r_err


def _loop_summary(summary, args, shell):
    """The reference's summary fields of loop closure and relocalization."""
    if args.loop:
        summary["loop_closures"] = len(shell.loop_events)
    if args.reloc:
        summary["relocalizations"] = len(shell.reloc_events)


def _dense_summary(summary, args, shell, rc, viewer=None):
    """The reference's summary fields of the dense volume (observed
    voxels, surface points, ``render_consistency`` when ``rc``), and the
    --save-surface / --save-mesh files; with a viewer, the mesh is logged
    once (meshing is host-side: end of run only)."""
    pts, _ = shell.dense_surface()
    vol = shell.tsdf if shell.tsdf is not None else shell.atlas
    summary["tsdf_observed_voxels"] = int((vol.weight > 0).sum())
    summary["tsdf_surface_points"] = len(pts)
    if shell.atlas is not None:
        summary["tsdf_submaps"] = min(shell.atlas.count,
                                      shell.atlas.capacity)
    if rc is not None:
        summary["render_consistency"] = rc
    if args.save_surface:
        np.save(args.save_surface, pts)
    if args.save_mesh:
        from kbslam_torch.mapping.mesh import save_ply, vertex_normals

        mesh = shell.dense_mesh()
        normals = vertex_normals(mesh)
        save_ply(args.save_mesh, mesh, normals)
        if viewer is not None:
            viewer.update_dense_mesh(mesh, normals)
        summary["mesh_vertices"] = len(mesh.vertices)
        summary["mesh_faces"] = len(mesh.faces)


def _rc_meta(rc):
    """render_consistency as checkpoint metadata."""
    return {f"render_consistency_{k}": v for k, v in rc.items()} if rc else None


def _resume_dense(args, cfg, shell):
    """--resume with --dense: the saved volume or atlas, or a warning
    that the dense model restarts empty."""
    from kbslam_torch.io.checkpoint import (load_checkpoint_atlas,
                                            load_checkpoint_tsdf)

    if args.dense_submaps:
        atlas, kf_ins = load_checkpoint_atlas(args.resume, cfg, shell.device)
        if atlas is not None:
            shell.restore_atlas(atlas, kf_ins)
            return
        what = "submap atlas"
    else:
        tsdf = load_checkpoint_tsdf(args.resume, cfg, shell.device)
        if tsdf is not None:
            shell.tsdf = tsdf
            return
        what = "TSDF volume"
    print(f"warning: checkpoint has no {what} — the dense map restarts "
          "empty and will only cover post-resume keyframes",
          file=sys.stderr)


def _icp_summary(summary, shell):
    """The reference's counts of accepted dense ICP rescues and refines."""
    for mode in ("rescue", "refine"):
        summary[f"icp_{mode}s"] = sum(
            1 for e in shell.icp_events if e["mode"] == mode and e["accepted"])


def _make_viewer(args):
    from kbslam_torch.viz.rerun_viewer import Viewer

    return Viewer(spawn=True) if args.viewer == "rerun" else None


def _view_dense(viewer, shell, depth_scale):
    """The dense model in the viewer: its surface cloud and a stride-4
    render from the newest fused keyframe, in the live depth feed's raw
    units (so both panes share the JET ramp)."""
    viewer.update_dense(shell.dense_surface()[0])
    r = shell.render_view(stride=4)
    if r is not None:
        viewer.update_rendered(r.depth.cpu().numpy() / depth_scale)


def _global_ba_cost_line(costs):
    print(f"global BA cost: {costs[0]:.2f} -> {costs[-1]:.2f}",
          file=sys.stderr)


def main(argv=None):
    ap = argparse.ArgumentParser("kbslam_torch")
    ap.add_argument("--source", default="synthetic",
                    help="synthetic | tum:<dir> | zmq[:<endpoint>]")
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--ba", choices=["on", "async", "off"], default="on",
                    help="local bundle adjustment after each keyframe, "
                    "overlapped with tracking, or none")
    ap.add_argument("--global-ba", action="store_true",
                    help="run a full-map bundle adjustment at the end")
    ap.add_argument("--mask", action="store_true",
                    help="apply static-element masks (reference mask path)")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--seed", type=int, default=0, help="RANSAC seed")
    ap.add_argument("--eval", action="store_true",
                    help="print ATE/RPE vs ground truth when available")
    ap.add_argument("--save-trajectory", default=None,
                    help="write TUM-format trajectory to this path")
    ap.add_argument("--save-checkpoint", default=None,
                    help="write the final SLAM state (npz) to this path")
    ap.add_argument("--resume", default=None,
                    help="resume from a checkpoint written by "
                    "--save-checkpoint")
    ap.add_argument("--dist", default=None,
                    help="comma-separated k1,k2,p1,p2,k3 lens distortion "
                    "(the zmq handshake's when unset)")
    ap.add_argument("--chunk", type=int, default=0,
                    help="track N frames per device dispatch (one CUDA "
                    "graph replay on the card) with the chunked streaming "
                    "executor; with --ba off or async. 0 = per-frame")
    ap.add_argument("--gray", action="store_true",
                    help="host-side grayscale ingress (only with --chunk)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when named (cpu)")
    ap.add_argument("--loop", action="store_true",
                    help="loop closure: place recognition and a pose-graph "
                    "correction (per frame and with --chunk)")
    ap.add_argument("--reloc", type=int, default=0, metavar="N",
                    help="relocalize after N consecutive tracking failures "
                    "(0 = lost for good, the reference's behaviour)")
    ap.add_argument("--cull", action="store_true",
                    help="keyframe culling (disabled in the reference)")
    ap.add_argument("--viewer", choices=["rerun", "none"], default="none",
                    help="log the trajectory, map and images to Rerun (a "
                    "recorder that logs nothing without the rerun SDK)")
    ap.add_argument("--viewer-every", type=int, default=0,
                    help="update the viewer every Nth frame (0 = every "
                    "frame per frame, once per chunk with --chunk)")
    ap.add_argument("--dense", action="store_true",
                    help="fuse keyframe depth into a dense TSDF volume (per "
                    "frame and with --chunk, where fusion runs chunk-late)")
    ap.add_argument("--save-surface", default=None, metavar="PATH.npy",
                    help="write the TSDF zero-crossing point cloud "
                    "(requires --dense)")
    ap.add_argument("--save-mesh", default=None, metavar="PATH.ply",
                    help="write the TSDF isosurface as a welded triangle "
                    "mesh with vertex normals, binary PLY (requires --dense)")
    ap.add_argument("--dense-submaps", type=int, default=0, metavar="K",
                    help="open a new TSDF submap every K keyframe "
                    "insertions, each anchored to its keyframe, so the "
                    "dense model follows BA and loop corrections (requires "
                    "--dense; 0 = one monolithic volume)")
    ap.add_argument("--dense-icp", choices=["off", "rescue", "refine"],
                    default="off",
                    help="frame-to-model tracking against the TSDF (requires "
                    "--dense, per frame only): 'rescue' recovers the pose "
                    "from geometry when PnP fails, 'refine' also polishes "
                    "tracked poses (with --dense-submaps only against "
                    "submaps the current tracking did not build)")
    ap.add_argument("--depth-edge-rel", type=float, default=0.0, metavar="R",
                    help="range-aware rim-gate term: spread threshold = "
                    "max(0.15, R*z^2); 0 = off")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="run under torch.profiler: DIR/trace.json, the "
                    "recorder's DIR/spans.json and a table of its spans, "
                    "stages and counters on stderr")
    args = ap.parse_args(argv)
    if args.chunk and args.ba == "on":
        ap.error("--chunk batches frames per dispatch, so synchronous "
                 "per-keyframe BA cannot interleave: use --ba async "
                 "(chunk-late concurrent BA) or --ba off")
    if args.gray and not args.chunk:
        ap.error("--gray requires --chunk")

    dist = [float(c) for c in args.dist.split(",")] if args.dist else None
    K, cfg, frames, dist = _frames(args, ap, dist)
    if (args.height, args.width) != (cfg.image_height, cfg.image_width):
        cfg = cfg.replace(image_height=args.height, image_width=args.width)
    if args.cull:
        cfg = cfg.replace(cull=dataclasses.replace(cfg.cull, enabled=True))
    if args.depth_edge_rel > 0:
        cfg = cfg.replace(map=dataclasses.replace(
            cfg.map, depth_edge_rel_per_m2=args.depth_edge_rel))
    if args.dense or args.save_surface or args.save_mesh:
        if not args.dense:
            ap.error("--save-surface/--save-mesh require --dense")
        cfg = cfg.replace(dense=dataclasses.replace(cfg.dense, enabled=True))
    if args.dense_submaps:
        if not args.dense:
            ap.error("--dense-submaps requires --dense")
        cfg = cfg.replace(dense=dataclasses.replace(
            cfg.dense, submap_every=args.dense_submaps))
    if args.dense_icp != "off":
        if not args.dense:
            ap.error("--dense-icp requires --dense (the TSDF volume is the "
                     "model)")
        if args.chunk:
            ap.error("--dense-icp runs on the per-frame path only (rescue "
                     "must intervene on the frame that failed; chunked "
                     "tracking has already committed the chunk)")
        cfg = cfg.replace(dense_icp=dataclasses.replace(
            cfg.dense_icp, mode=args.dense_icp))
    if args.loop or args.reloc:
        cfg = cfg.replace(loop=dataclasses.replace(
            cfg.loop, enabled=bool(args.loop), reloc_after=args.reloc))
    run = _run_chunked if args.chunk else _run_per_frame
    if not args.trace:
        run(args, cfg, K, frames, dist)
        return
    from kbslam_torch.utils import profiling

    with profiling.device_trace(args.trace, args.device):
        run(args, cfg, K, frames, dist)
    with open(os.path.join(args.trace, "spans.json"), "w") as f:
        json.dump(profiling.records(), f)
    print(profiling.report(), file=sys.stderr)


def _run_per_frame(args, cfg, K, frames, dist):
    """Tracking frame by frame through ``slam.SLAM``."""
    from kbslam_torch.slam import SLAM

    mode = {"on": "on_keyframe", "async": "async", "off": "disabled"}[args.ba]
    slam = SLAM(cfg, K, ba_mode=mode, use_mask=args.mask, seed=args.seed,
                dist=dist, device=args.device)
    print(f"kbslam_torch: device {slam.device}", file=sys.stderr)
    if args.resume:
        from kbslam_torch.io.checkpoint import load_checkpoint

        slam.state, _ = load_checkpoint(args.resume, cfg, slam.device)
        if args.dense:
            _resume_dense(args, cfg, slam)
    viewer = _make_viewer(args)
    gts, n = [], 0
    for rgb, depth, mask, gt in frames:
        if n >= args.frames:
            break
        d = slam.process(rgb, depth, mask if args.mask else None)
        if gt is not None:
            gts.append(gt)
        if viewer is not None and (not args.viewer_every
                                   or n % args.viewer_every == 0):
            traj = np.stack([T[:3, 3] for T in slam.frame_poses])
            viewer.update(traj, slam.keyframe_positions(), slam.map_points(),
                          rgb, depth, mask)
        # the dense model changes only on fusion: keyframe frames, not
        # the --viewer-every phase
        if viewer is not None and args.dense and d["added_kf"]:
            _view_dense(viewer, slam, cfg.map.depth_scale)
        if d["frame"] % 30 == 0:
            print(f"frame {d['frame']}: success={d['success']} "
                  f"kf={d['added_kf']} inliers={d['num_inliers']} "
                  f"{d['wall_ms']:.1f} ms", file=sys.stderr)
        n += 1
    slam.finish()
    if args.global_ba:
        _global_ba_cost_line(slam.run_global_ba())

    est = np.stack(slam.frame_poses)
    summary = dict(
        frames=n,
        success=sum(x["success"] for x in slam.diagnostics),
        keyframes=slam.num_keyframes,
        ba_runs=len(slam.ba_stats),
        mean_track_ms=float(np.mean([x["wall_ms"]
                                     for x in slam.diagnostics][1:]))
        if n > 1 else None,
    )
    _loop_summary(summary, args, slam)
    if args.dense_icp != "off":
        _icp_summary(summary, slam)
    rc = None
    if args.dense:
        rc = slam.map_consistency()
        _dense_summary(summary, args, slam, rc, viewer)
    if args.eval and len(gts) == n and n > 1:
        # with any solver: the local BA or the end-of-run global one
        _evaluate(summary, est, gts, slam.refined_trajectory()
                  if mode != "disabled" or args.global_ba else None)
    if args.save_checkpoint:
        from kbslam_torch.io.checkpoint import save_checkpoint

        save_checkpoint(args.save_checkpoint, slam.state,
                        trajectory=slam.frame_poses, tsdf=slam.tsdf,
                        atlas=slam.atlas, kf_insertions=slam._kf_insertions,
                        meta=_rc_meta(rc))
    if args.save_trajectory:
        _save_trajectory(args.save_trajectory, est)
    print(json.dumps(summary))


def _run_chunked(args, cfg, K, frames, dist):
    """Tracking through the chunked streaming executor
    (kbslam_torch/streaming.py): N frames per dispatch, results drained
    up to 2N frames late; --ba async overlaps chunk-late local BA."""
    from kbslam_torch.device import pick_device
    from kbslam_torch.geom.camera import Intrinsics
    from kbslam_torch.pipeline import init_state
    from kbslam_torch.slam import (pose_T, refine_frame_poses,
                                   run_global_ba_on_map)
    from kbslam_torch.streaming import ChunkedStream, assign_state

    device = pick_device(args.device)
    print(f"kbslam_torch: device {device}", file=sys.stderr)
    intr = Intrinsics.from_matrix(K, dist=dist)
    if args.resume:
        from kbslam_torch.io.checkpoint import load_checkpoint

        state, _ = load_checkpoint(args.resume, cfg, device)
    else:
        state = init_state(cfg, device)
    cs = ChunkedStream(cfg, intr, state, chunk=args.chunk, gray=args.gray,
                       use_mask=args.mask, seed=args.seed,
                       ba_mode="async" if args.ba == "async" else "off")
    if args.resume and args.dense:
        _resume_dense(args, cfg, cs)
    viewer = _make_viewer(args)
    view = _ChunkedView(viewer, cs, args, cfg.map.depth_scale)
    results, gts, n = [], [], 0
    t0 = time.perf_counter()
    for rgb, depth, mask, gt in frames:
        if n >= args.frames:
            break
        view.hold(n, rgb, depth, mask)
        got = cs.feed(rgb, depth, mask if args.mask else None)
        view(got)
        results += got
        if gt is not None:
            gts.append(gt)
        n += 1
    got = cs.flush()
    view(got)
    results += got
    wall = time.perf_counter() - t0
    if args.global_ba:
        new_map, costs = run_global_ba_on_map(cs.state.map, intr, cfg.ba)
        # into the stream's own buffers (on CUDA the graph's)
        assign_state(cs.state, cs.state._replace(map=new_map))
        _global_ba_cost_line(costs)

    est = [pose_T(r["pose_q"], r["pose_t"]) for r in results]
    est = np.stack(est) if est else np.zeros((0, 4, 4))
    rc = cs.map_consistency() if args.dense else None
    if args.save_checkpoint:
        from kbslam_torch.io.checkpoint import save_checkpoint

        save_checkpoint(args.save_checkpoint, cs.state, trajectory=list(est),
                        tsdf=cs.tsdf, atlas=cs.atlas,
                        kf_insertions=cs._kf_insertions, meta=_rc_meta(rc))
    summary = dict(
        frames=n,
        success=sum(r["success"] for r in results),
        keyframes=int(np.sum([r["added_kf"] for r in results])),
        ba_runs=len(cs.ba_stats),
        chunk=args.chunk,
        gray_ingress=bool(args.gray),
        streaming_fps=round(n / wall, 1) if wall > 0 else None,
    )
    _loop_summary(summary, args, cs)
    if args.dense:
        _dense_summary(summary, args, cs, rc, viewer)
    if args.eval and len(gts) == n and n > 1:
        refined = None
        if cs.ba_stats or args.global_ba:
            anchors = [(r["anchor_id"], pose_T(r["anchor_q"], r["anchor_t"]))
                       for r in results]
            refined = refine_frame_poses(list(est), anchors, cs.state.map)
        _evaluate(summary, est, gts, refined)
    if args.save_trajectory:
        _save_trajectory(args.save_trajectory, est)
    print(json.dumps(summary))


class _ChunkedView:
    """The viewer on the chunked path, fed with the drained results: one
    update per ``view_every`` frames (--viewer-every, else the chunk),
    for the drained frames whose index it divides, and with --dense at
    most one surface and render per ``view_every`` frames, on a drained
    keyframe.

    The map it shows is the live state, the state after the newest
    dispatched replay, as the reference's CLI reads its live carry: each
    read is a copy to the host on the stream (``map_keyframe_positions``,
    ``map_point_positions``), made after that replay and complete before
    the next is dispatched, so no view of the graph's static buffers
    outlives a replay. Such a read waits for the chunk in flight. The
    viewer never writes the state."""

    def __init__(self, viewer, cs, args, depth_scale: float):
        self.viewer, self.cs = viewer, cs
        self.dense, self.depth_scale = args.dense, depth_scale
        self.every = args.viewer_every or args.chunk
        self.frames = {}        # frame index -> (rgb, depth, mask)
        self.traj = []
        self.last_dense = -10**9  # frame of the last dense update

    def hold(self, i: int, rgb, depth, mask):
        """Keep frame ``i``'s images until it drains."""
        if self.viewer is not None:
            self.frames[i] = (rgb, depth, mask)

    def __call__(self, drained):
        from kbslam_torch.slam import (map_keyframe_positions,
                                       map_point_positions)

        for r in drained:
            self.traj.append(r["pose_t"])
            if self.viewer is None:
                continue
            if r["frame"] % self.every == 0:
                m = self.cs.state.map
                self.viewer.update(np.stack(self.traj),
                                   map_keyframe_positions(m),
                                   map_point_positions(m),
                                   *self.frames[r["frame"]])
            if (self.dense and r["added_kf"]
                    and r["frame"] - self.last_dense >= self.every):
                _view_dense(self.viewer, self.cs, self.depth_scale)
                self.last_dense = r["frame"]
        for r in drained:
            self.frames.pop(r["frame"], None)


if __name__ == "__main__":
    main()
