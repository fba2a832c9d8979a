"""Command-line entry point of the port: ``python -m kbslam_torch.cli``.

The subset of ``python -m kbslam.cli`` that the port covers: the
synthetic source, tracking with local BA off, and the evaluation
summary. Any other flag is refused. Prints the same summary JSON keys
as the reference CLI for these flags.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser("kbslam_torch")
    ap.add_argument("--source", choices=["synthetic"], default="synthetic")
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--ba", choices=["off"], default="off",
                    help="local bundle adjustment is not ported yet")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--seed", type=int, default=0,
                    help="RANSAC seed")
    ap.add_argument("--eval", action="store_true",
                    help="print ATE/RPE vs ground truth")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when named (cpu)")
    args = ap.parse_args(argv)

    from kbslam_torch import config
    from kbslam_torch.eval import trajectory
    from kbslam_torch.io import synthetic
    from kbslam_torch.slam import SLAM

    seq = synthetic.render_sequence(num_frames=args.frames, height=args.height,
                                    width=args.width,
                                    fx=525.0 * args.width / 640.0)
    cfg = config.DEFAULT_CONFIG.replace(image_height=args.height,
                                        image_width=args.width)
    slam = SLAM(cfg, seq.K, ba_mode="disabled", use_mask=False,
                seed=args.seed, device=args.device)
    print(f"kbslam_torch: device {slam.device}", file=sys.stderr)
    n = 0
    for i in range(len(seq.rgb)):
        d = slam.process(seq.rgb[i], seq.depth[i])
        if d["frame"] % 30 == 0:
            print(f"frame {d['frame']}: success={d['success']} "
                  f"kf={d['added_kf']} inliers={d['num_inliers']} "
                  f"{d['wall_ms']:.1f} ms", file=sys.stderr)
        n += 1

    est = np.stack(slam.frame_poses)
    summary = dict(
        frames=n,
        success=sum(x["success"] for x in slam.diagnostics),
        keyframes=slam.num_keyframes,
        ba_runs=0,
        mean_track_ms=float(np.mean([x["wall_ms"]
                                     for x in slam.diagnostics][1:]))
        if n > 1 else None,
    )
    if args.eval and n > 1:
        gt = seq.poses[:n]
        summary["ate_rmse_m"] = trajectory.ate_rmse(est[:, :3, 3],
                                                    gt[:, :3, 3])
        t_err, r_err = trajectory.rpe(est, gt)
        summary["rpe_trans_m"] = t_err
        summary["rpe_rot_rad"] = r_err
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
