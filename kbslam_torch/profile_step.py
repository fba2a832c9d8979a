"""Where the tracking step's time goes, on a CUDA device.

    python -m kbslam_torch.profile_step [--frames 40] [--height 480 --width 640]

Tracks a synthetic sequence at the default configuration four ways:

1. plain: wall time per frame (the step ends in a device-to-host copy
   of its outputs, so each frame is complete when its time is taken);
2. staged: the stages of the step wrapped with a device synchronize at
   each edge, giving each stage's wall time (nested stages are listed
   under their parent; the syncs add a little time of their own);
3. profiled: ``torch.profiler`` over the plain step, for the device's
   kernel time per frame, the number of kernel launches per frame and
   the device's busy share of the wall time;
4. host syncs: the operations that wait for the device in one frame
   (``torch.cuda.set_sync_debug_mode``); the output copy is one.

Prints one JSON object as the last line.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import time
import warnings

import numpy as np
import torch


def _timed(table, name, fn):
    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        table[name].append(time.perf_counter() - t0)
        return out
    return wrapper


def _stage_hooks(table):
    """(module, attribute, stage name) wrapped by the staged run."""
    from kbslam_torch import pipeline
    from kbslam_torch.frontend import orb

    return [
        (pipeline, "extract_frame", "frontend"),
        (orb, "build_pyramid", "frontend/pyramid"),
        (orb, "fast_score_map", "frontend/fast"),
        (orb, "nms3x3", "frontend/nms"),
        (orb, "harris_response", "frontend/harris"),
        (orb, "select_level", "frontend/topk_select"),
        (orb, "gaussian_blur", "frontend/blur"),
        (orb, "describe_keypoints", "frontend/describe(kernel)"),
        (pipeline, "knn2_ratio_match", "match"),
        (pipeline, "ransac_pnp", "ransac"),
        (pipeline, "insert_keyframe", "insert_keyframe"),
        (pipeline, "create_map_points", "create_map_points"),
    ]


def main(argv=None):
    ap = argparse.ArgumentParser("kbslam_torch.profile_step")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    args = ap.parse_args(argv)
    from kbslam_torch import config
    from kbslam_torch.device import pick_device
    from kbslam_torch.io import synthetic
    from kbslam_torch.slam import SLAM

    dev = pick_device()     # the card; raises without one

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    seq = synthetic.render_sequence(num_frames=args.frames, height=args.height,
                                    width=args.width)
    cfg = config.SLAMConfig().replace(image_height=args.height,
                                      image_width=args.width)

    def run(slam):
        walls = []
        for i in range(args.frames):
            t0 = time.perf_counter()
            slam.process(seq.rgb[i], seq.depth[i])
            walls.append((time.perf_counter() - t0) * 1e3)
        return walls

    # 1. plain
    plain = run(SLAM(cfg, seq.K, device=dev))
    # 2. staged
    table = collections.defaultdict(list)
    hooks = _stage_hooks(table)
    saved = [(m, a, getattr(m, a)) for m, a, _ in hooks]
    for m, a, name in hooks:
        setattr(m, a, _timed(table, name, getattr(m, a)))
    try:
        staged = run(SLAM(cfg, seq.K, device=dev))
    finally:
        for m, a, fn in saved:
            setattr(m, a, fn)
    # 3. profiled (frames after the first two)
    from torch.profiler import ProfilerActivity, profile

    slam = SLAM(cfg, seq.K, device=dev)
    for i in range(2):
        slam.process(seq.rgb[i], seq.depth[i])
    n_prof = min(5, args.frames - 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(2, 2 + n_prof):
            slam.process(seq.rgb[i], seq.depth[i])
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3 / n_prof
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.device_time for e in kernels) / 1e3 / n_prof
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.device_time / 1e3 / n_prof
    top = [[k[:60], round(v, 4)] for k, v in by_name.most_common(8)]

    # 4. host syncs in one steady frame
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            slam.process(seq.rgb[-1], seq.depth[-1])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = collections.Counter(
        f"{w.filename.rsplit('kbslam_torch', 1)[-1]}:{w.lineno}"
        for w in caught if "synchroniz" in str(w.message))

    skip = 2   # first frames: build, caches, allocator warm-up
    stages = {name: float(np.sum(v) * 1e3 / len(staged))
              for name, v in table.items()}
    result = {
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "frames": args.frames, "hw": [args.height, args.width],
        "plain_ms_median": float(np.median(plain[skip:])),
        "plain_fps": float(1e3 / np.mean(plain[skip:])),
        "staged_ms_median": float(np.median(staged[skip:])),
        "stage_ms_per_frame": stages,
        "profiled_wall_ms": prof_wall,
        "device_kernel_ms_per_frame": dev_ms,
        "device_busy_share": dev_ms / prof_wall,
        "kernel_launches_per_frame": len(kernels) / n_prof,
        "top_kernels_ms_per_frame": top,
        "host_syncs_per_frame": sum(syncs.values()),
        "host_sync_kinds": dict(syncs),
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
