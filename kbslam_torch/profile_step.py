"""Where a frame's time goes, on a CUDA device.

    python -m kbslam_torch.profile_step [--frames 40] [--height 480 --width 640]
                                        [--ba {off,on}]

Tracks a synthetic sequence at the default configuration four ways
(with ``--ba on`` as the system's default path, a local BA after each
keyframe insertion; off by default, the tracking step alone):

1. plain: wall time per frame of ``SLAM.process``, which replays its
   programs as CUDA graphs (the step ends in a device-to-host copy of
   its outputs, so each frame is complete when its time is taken);
2. staged: the same frames through the eager calls of the step (and
   the solve), with the stages wrapped with a device synchronize at
   each edge, giving each stage's wall time (nested stages are listed
   under their parent; the syncs add a little time of their own, and
   no sync can sit inside a graph capture);
3. profiled: ``torch.profiler`` over the plain step, for the device's
   kernel time per frame, the number of kernel launches per frame (the
   kernels of a graph replay included) and the device's busy share of
   the wall time;
4. host syncs: the operations that wait for the device in one frame
   (``torch.cuda.set_sync_debug_mode``); the output copy is one.

With ``--ba on`` it also measures one local BA on the final map: host
ms per solve, device ms per solve (CUDA events on the stream, and the
replay of the solve captured as a CUDA graph, which leaves the host's
launch time out), kernel launches and device kernel time per solve
(``torch.profiler``), host syncs per solve, and the wall time of frames
that ran a solve beside those that did not.

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


def sync_sites(fn):
    """{file:line: count} of the operations in ``fn()`` that wait for
    the device (``torch.cuda.set_sync_debug_mode``)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return collections.Counter(
        f"{w.filename.rsplit('kbslam_torch', 1)[-1]}:{w.lineno}"
        for w in caught if "synchroniz" in str(w.message))


def _kernel_events(fn, n):
    """(wall ms, device kernel ms, kernel launches, top kernels), each per
    call, of ``n`` calls of ``fn`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.device_time / 1e3 / n
    top = [[k[:60], round(v, 4)] for k, v in by_name.most_common(8)]
    return (wall, sum(e.device_time for e in kernels) / 1e3 / n,
            len(kernels) / n, top)


def _graph_ms(fn, replays=5):
    """Device ms per call of ``fn`` captured as a CUDA graph and replayed,
    so the host's launches are out of the way (``fn`` must make no host
    sync)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / replays


def _ba_stage(slam, walls):
    """One local BA on ``slam``'s map, measured every way the module
    docstring lists."""
    from kbslam_torch.ba.local_ba import local_ba

    m, cfg, intr = slam.state.map, slam.config.ba, slam.intr

    def solve():
        return local_ba(m, intr, cfg)

    solve()
    torch.cuda.synchronize()
    host, ev = [], []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        solve()
        end.record()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        ev.append(start.elapsed_time(end))
    _, kernel_ms, launches, top = _kernel_events(solve, 2)
    syncs = sync_sites(solve)
    kf = [w for w, d in zip(walls, slam.diagnostics) if d["ran_ba"]][1:]
    plain = [w for w, d in zip(walls, slam.diagnostics) if not d["ran_ba"]][2:]
    return {
        "solve_host_ms": host, "solve_event_ms": ev,
        "solve_graph_replay_ms": _graph_ms(solve),
        "solve_kernel_ms": kernel_ms, "solve_kernel_launches": launches,
        "solve_top_kernels_ms": top,
        "solve_host_syncs": sum(syncs.values()), "solve_sync_kinds": dict(syncs),
        "solves_in_run": len(slam.ba_stats),
        "keyframe_frame_ms": kf, "plain_frame_ms_median": float(np.median(plain)),
    }


def _eager_run(cfg, seq, dev, frames, ba):
    """Wall ms per frame of the per-frame path as eager calls: the
    tracking step, and with ``ba`` a local BA after each keyframe
    insertion, each frame ending in its one output copy."""
    from kbslam_torch.ba import local_ba as ba_module
    from kbslam_torch.geom.camera import Intrinsics
    from kbslam_torch.pipeline import init_state, make_track_step
    from kbslam_torch.slam import output_to_host

    intr = Intrinsics.from_matrix(seq.K)
    step = make_track_step(cfg, intr)
    state = init_state(cfg, dev)
    ones = torch.ones(seq.depth.shape[1:], dtype=torch.uint8, device=dev)
    walls = []
    for i in range(frames):
        t0 = time.perf_counter()
        rgb = torch.from_numpy(seq.rgb[i]).to(dev)
        depth = torch.from_numpy(seq.depth[i].astype(np.int32)).to(dev)
        state, out = step(state, rgb, depth, ones)
        if output_to_host(out)["added_kf"] and ba:
            m, stats = ba_module.local_ba(state.map, intr, cfg.ba)
            state = state._replace(map=m)
            ba_module.stats_vector(stats).cpu()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


def main(argv=None):
    ap = argparse.ArgumentParser("kbslam_torch.profile_step")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--ba", choices=["off", "on"], default="off",
                    help="run a local BA after each keyframe insertion")
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
    mode = "on_keyframe" if args.ba == "on" else "disabled"

    def new_slam():
        return SLAM(cfg, seq.K, ba_mode=mode, device=dev)

    def run(slam):
        walls = []
        for i in range(args.frames):
            t0 = time.perf_counter()
            slam.process(seq.rgb[i], seq.depth[i])
            walls.append((time.perf_counter() - t0) * 1e3)
        return walls

    # 1. plain
    plain_slam = new_slam()
    plain = run(plain_slam)
    # 2. staged
    table = collections.defaultdict(list)
    hooks = _stage_hooks(table)
    if args.ba == "on":
        from kbslam_torch.ba import local_ba as ba_module

        hooks.append((ba_module, "local_ba", "local_ba"))
    saved = [(m, a, getattr(m, a)) for m, a, _ in hooks]
    for m, a, name in hooks:
        setattr(m, a, _timed(table, name, getattr(m, a)))
    try:
        staged = _eager_run(cfg, seq, dev, args.frames, args.ba == "on")
    finally:
        for m, a, fn in saved:
            setattr(m, a, fn)
    # 3. profiled (frames after the first two)
    slam = new_slam()
    for i in range(2):
        slam.process(seq.rgb[i], seq.depth[i])
    n_prof = min(5, args.frames - 2)
    frames = iter(range(2, 2 + n_prof))

    def next_frame():
        i = next(frames)
        slam.process(seq.rgb[i], seq.depth[i])

    prof_wall, dev_ms, n_launch, top = _kernel_events(next_frame, n_prof)
    # 4. host syncs in one steady frame
    syncs = sync_sites(lambda: slam.process(seq.rgb[-1], seq.depth[-1]))

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
        "kernel_launches_per_frame": n_launch,
        "top_kernels_ms_per_frame": top,
        "host_syncs_per_frame": sum(syncs.values()),
        "host_sync_kinds": dict(syncs),
    }
    if args.ba == "on":
        result["ba"] = _ba_stage(plain_slam, plain)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
