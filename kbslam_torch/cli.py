"""Command-line entry point of the port: ``python -m kbslam_torch.cli``.

The subset of ``python -m kbslam.cli`` that the port covers, with the
same flags, validation errors and summary JSON keys:

- sources: ``synthetic`` (rendered RGB-D with ground truth, the default)
  and ``tum:<dir>`` (a TUM RGB-D sequence directory);
- per-frame tracking with local BA after each keyframe (``--ba on``, the
  default), asynchronous (``async``) or off;
- ``--chunk N``: the chunked streaming executor (``streaming.py``, one
  CUDA graph replay per N frames on the card), with ``--ba off`` or
  ``async`` and optional ``--gray`` ingress;
- ``--loop`` (loop closure), ``--reloc N`` (relocalization after N
  failures in a row) and ``--cull`` (keyframe culling), per frame and
  with ``--chunk``;
- ``--mask``, ``--dist``, ``--save-trajectory``, ``--save-checkpoint``,
  ``--resume`` and ``--eval``.

``--viewer`` and ``--dense`` belong to later slices of the port
(ROADMAP.md) and are refused; so is any other flag.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

_LATER = {"viewer": "the Rerun viewer", "dense": "dense mapping (Slice E)"}


def _frames(args, ap):
    """(K, config, iterator of (rgb, depth, mask, T_wc or None))."""
    from kbslam_torch.config import DEFAULT_CONFIG

    if args.source.startswith("tum:"):
        from kbslam_torch.io.tum import TUMDataset

        ds = TUMDataset(args.source[4:])
        cfg = DEFAULT_CONFIG.replace(map=dataclasses.replace(
            DEFAULT_CONFIG.map, depth_scale=ds.depth_scale))
        return ds.K, cfg, iter(ds)
    if args.source != "synthetic":
        ap.error(f"unknown --source {args.source!r} "
                 "(expected synthetic | tum:<dir>)")
    from kbslam_torch.io.synthetic import render_sequence

    seq = render_sequence(num_frames=args.frames, height=args.height,
                          width=args.width, fx=525.0 * args.width / 640.0)
    frames = ((seq.rgb[i], seq.depth[i], seq.mask[i], seq.poses[i])
              for i in range(len(seq.rgb)))
    return seq.K, DEFAULT_CONFIG, frames


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


def main(argv=None):
    ap = argparse.ArgumentParser("kbslam_torch")
    ap.add_argument("--source", default="synthetic",
                    help="synthetic | tum:<dir>")
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--ba", choices=["on", "async", "off"], default="on",
                    help="local bundle adjustment after each keyframe, "
                    "overlapped with tracking, or none")
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
                    help="comma-separated k1,k2,p1,p2,k3 lens distortion")
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
    ap.add_argument("--viewer", choices=["rerun", "none"], default="none")
    ap.add_argument("--dense", action="store_true")
    args = ap.parse_args(argv)
    for flag, what in _LATER.items():
        if getattr(args, flag) not in (False, 0, "none"):
            ap.error(f"--{flag}: {what} is not ported yet (ROADMAP.md)")
    if args.chunk and args.ba == "on":
        ap.error("--chunk batches frames per dispatch, so synchronous "
                 "per-keyframe BA cannot interleave: use --ba async "
                 "(chunk-late concurrent BA) or --ba off")
    if args.gray and not args.chunk:
        ap.error("--gray requires --chunk")

    K, cfg, frames = _frames(args, ap)
    if (args.height, args.width) != (cfg.image_height, cfg.image_width):
        cfg = cfg.replace(image_height=args.height, image_width=args.width)
    if args.cull:
        cfg = cfg.replace(cull=dataclasses.replace(cfg.cull, enabled=True))
    if args.loop or args.reloc:
        cfg = cfg.replace(loop=dataclasses.replace(
            cfg.loop, enabled=bool(args.loop), reloc_after=args.reloc))
    dist = [float(c) for c in args.dist.split(",")] if args.dist else None
    if args.chunk:
        _run_chunked(args, cfg, K, frames, dist)
        return

    from kbslam_torch.slam import SLAM

    mode = {"on": "on_keyframe", "async": "async", "off": "disabled"}[args.ba]
    slam = SLAM(cfg, K, ba_mode=mode, use_mask=args.mask, seed=args.seed,
                dist=dist, device=args.device)
    print(f"kbslam_torch: device {slam.device}", file=sys.stderr)
    if args.resume:
        from kbslam_torch.io.checkpoint import load_checkpoint

        slam.state, _ = load_checkpoint(args.resume, cfg, slam.device)
    gts, n = [], 0
    for rgb, depth, mask, gt in frames:
        if n >= args.frames:
            break
        d = slam.process(rgb, depth, mask if args.mask else None)
        if gt is not None:
            gts.append(gt)
        if d["frame"] % 30 == 0:
            print(f"frame {d['frame']}: success={d['success']} "
                  f"kf={d['added_kf']} inliers={d['num_inliers']} "
                  f"{d['wall_ms']:.1f} ms", file=sys.stderr)
        n += 1
    slam.finish()

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
    if args.eval and len(gts) == n and n > 1:
        _evaluate(summary, est, gts, slam.refined_trajectory()
                  if mode != "disabled" else None)
    if args.save_checkpoint:
        from kbslam_torch.io.checkpoint import save_checkpoint

        save_checkpoint(args.save_checkpoint, slam.state,
                        trajectory=slam.frame_poses)
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
    from kbslam_torch.slam import pose_T, refine_frame_poses
    from kbslam_torch.streaming import ChunkedStream

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
    results, gts, n = [], [], 0
    t0 = time.perf_counter()
    for rgb, depth, mask, gt in frames:
        if n >= args.frames:
            break
        results += cs.feed(rgb, depth, mask if args.mask else None)
        if gt is not None:
            gts.append(gt)
        n += 1
    results += cs.flush()
    wall = time.perf_counter() - t0

    est = [pose_T(r["pose_q"], r["pose_t"]) for r in results]
    est = np.stack(est) if est else np.zeros((0, 4, 4))
    if args.save_checkpoint:
        from kbslam_torch.io.checkpoint import save_checkpoint

        save_checkpoint(args.save_checkpoint, cs.state, trajectory=list(est))
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
    if args.eval and len(gts) == n and n > 1:
        refined = None
        if cs.ba_stats:
            anchors = [(r["anchor_id"], pose_T(r["anchor_q"], r["anchor_t"]))
                       for r in results]
            refined = refine_frame_poses(list(est), anchors, cs.state.map)
        _evaluate(summary, est, gts, refined)
    if args.save_trajectory:
        _save_trajectory(args.save_trajectory, est)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
