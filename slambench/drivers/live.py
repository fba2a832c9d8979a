"""Driver ``live``: one camera, open loop at its frame rate, through
``SLAM.process``.

This is the reference's own use: a live camera whose every keyframe
runs its local BA before the next pose (``ba_mode`` of the traffic
file). Frame j of the window is due at ``t0 + j / rate_hz``; it is sent
when due, or at once when the previous frame returned late, and timed
from when it was due, so a stall counts against every frame it delays.
The window is a fixed number of frames, ``seconds * rate_hz``.

During the window the driver copies the program's state before each
frame of a few stretches drawn from the seed (``check``: ``stretches``
of ``stretch_frames``), on the device between frames; after the window
the reference runs each such frame from that state and is held to what
the program answered and the state it left (``harness/compare.py``).
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from slambench.harness import compare, report, scene
from slambench.harness.context import Result
from slambench.harness.control import tf32_products
from slambench.harness.setup import (config_dict, free_device, peak_bytes,
                                     program_peak, slam_config, state_bytes,
                                     sync)
from slambench.harness.trace import Tracer


def stretches(seed: int, frames: int, count: int, length: int) -> list:
    """``count`` starts of ``length``-frame stretches, one drawn from the
    seed in each of ``count`` equal parts of the window."""
    rng = np.random.default_rng(seed)
    part = frames // count
    if part <= length:
        raise ValueError(f"{count} stretches of {length} frames do not fit "
                         f"in {frames} frames")
    return [k * part + int(rng.integers(0, part - length))
            for k in range(count)]


def program_answers(slam, first: int) -> list:
    """Per frame from ``first`` on: the pose, the decisions and, when the
    frame solved, the solve's final cost."""
    costs = iter(slam.ba_stats)
    out = []
    for i, d in enumerate(slam.diagnostics):
        cost = next(costs)["final_cost"] if d["ran_ba"] else None
        if i >= first:
            T = slam.frame_poses[i]
            out.append(dict(R=T[:3, :3], t=T[:3, 3], success=d["success"],
                            added_kf=d["added_kf"],
                            num_inliers=d["num_inliers"], cost=cost))
    return out


def reference_frame(ref, st, frame, control: bool):
    """The reference's step (and solve, after an insertion) from the
    state ``st``: (answer, map after, final cost or None)."""
    ctx = tf32_products() if control else contextlib.nullcontext()
    with ctx:
        new, out = ref["step"](st, *frame)
        cost = None
        if bool(out.added_kf) and ref["ba"] is not None:
            m, stats = ref["ba"](new.map)
            new = new._replace(map=m)
            cost = float(stats.final_cost)
    R = compare.quat_matrix(out.pose_q.cpu().numpy())
    answer = dict(R=R, t=out.pose_t.double().cpu().numpy(),
                  success=bool(out.success), added_kf=bool(out.added_kf),
                  num_inliers=int(out.num_inliers), cost=cost)
    return answer, out, new.map, cost


def run(ctx):
    from kbslam_torch import config as program_config
    from kbslam_torch import device as program_device
    from kbslam_torch.slam import SLAM

    dev = ctx.device
    cfg = config_dict(ctx)
    traffic = ctx.cell.traffic
    cam = cfg["camera"]
    rgb_d, depth_d, gt = scene.camera_frames(cfg, ctx.seed, dev)
    rgb = rgb_d[:, 0].cpu().numpy()
    depth = depth_d[:, 0].cpu().numpy().astype(np.uint16)
    gt = gt[:, 0]
    del rgb_d, depth_d
    free_device(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    P = rgb.shape[0]
    mask = np.full(depth.shape[1:], 255, np.uint8)
    K = scene.intrinsics(cam)
    slam = SLAM(slam_config(program_config, cfg["slam"]), K,
                ba_mode=traffic["ba_mode"], use_mask=True, seed=ctx.seed,
                device=dev)
    warm = int(traffic["warmup_frames"])
    for i in range(warm):
        slam.process(rgb[i % P], depth[i % P], mask)
    if dev.type == "cuda":
        missing = [p for p in traffic["programs"]
                   if not slam.graphs.get(p) or not slam.graphs[p].graphs]
        if missing:
            raise RuntimeError(f"warm-up left {missing} uncaptured")

    rate = float(traffic["rate_hz"])
    N = int(round(ctx.seconds * rate))
    chk = traffic["check"]
    L = int(chk["stretch_frames"])
    starts = stretches(ctx.seed, N, int(chk["stretches"]), L)
    before = peak_bytes(dev)
    snaps = {j: compare.empty_like_state(slam.state)
             for s in starts for j in range(s, s + L + 1)}
    traced = int(traffic["trace"]["frames"])
    tracer = Tracer(ctx.trace, dev.type == "cuda")
    captures0 = sum(program_device.captures.values())
    sync(dev)

    setup_s = report.process_age_s()
    latency, lateness, wall = [], [], []
    t0 = time.perf_counter() + 0.005
    for j in range(N):
        if j in snaps:
            compare.snapshot_into(snaps[j], slam.state)
        if j == N - traced:
            tracer.start()
        due = t0 + j / rate
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        start = time.perf_counter()
        f = (warm + j) % P
        with tracer.span("frame", j):
            slam.process(rgb[f], depth[f], mask)
        end = time.perf_counter()
        latency.append((end - due) * 1e3)
        wall.append((end - start) * 1e3)
        lateness.append((start - due) * 1e3)
    if N in snaps:
        compare.snapshot_into(snaps[N], slam.state)
    tracer.stop()
    window_s = time.perf_counter() - t0
    sync(dev)
    peak = program_peak(dev, before, state_bytes(snaps.values()))
    captured = sum(program_device.captures.values()) - captures0
    if captured:
        raise RuntimeError(f"{captured} capture(s) inside the window")

    answers = program_answers(slam, warm)
    solves = [j for j, a in enumerate(answers) if a["cost"] is not None]
    failed = sum(not a["success"] for a in answers)
    est = np.stack([a["t"] for a in answers])
    truth = gt[[(warm + j) % P for j in range(N)], :3, 3]
    replays = {k: g.replays for k, g in slam.graphs.items()}
    del slam
    free_device(dev)

    from slambench.harness.trajectory import ate_rmse
    from slambench.reference import config as ref_config
    from slambench.reference import pipeline as ref_pipeline
    from slambench.reference.ba.local_ba import local_ba
    from slambench.reference.geom.camera import Intrinsics

    rcfg = slam_config(ref_config, cfg["slam"])
    rintr = Intrinsics.from_matrix(K)
    ref = dict(step=ref_pipeline.make_track_step(rcfg, rintr, use_mask=True,
                                                 seed=ctx.seed),
               ba=(lambda m: local_ba(m, rintr, rcfg.ba))
               if traffic["ba_mode"] == "on_keyframe" else None)
    gaps, ctl_gaps = compare.Gaps(), compare.Gaps()
    t_ref = time.perf_counter()
    mask_t = torch.from_numpy(mask).to(dev)
    for s in starts:
        for j in range(s, s + L):
            f = (warm + j) % P
            frame = (torch.from_numpy(rgb[f]).to(dev),
                     torch.from_numpy(depth[f].astype(np.int32)).to(dev),
                     mask_t)
            st = compare.to_reference(ref_pipeline, snaps[j])
            _, r_out, r_map, r_cost = reference_frame(ref, st, frame,
                                                          False)
            gaps.frame(answers[j], r_out, snaps[j + 1].map, r_map,
                       answers[j]["cost"], r_cost)
            if ctx.control:
                st = compare.to_reference(ref_pipeline, snaps[j])
                c_ans, _, c_map, c_cost = reference_frame(ref, st, frame,
                                                          True)
                ctl_gaps.frame(c_ans, r_out, c_map, r_map, c_cost, r_cost)
    ref_s = time.perf_counter() - t_ref

    metrics = dict(frame_p50_ms=report.median(latency),
                   frame_p95_ms=report.percentile(latency, 95.0),
                   setup_s=setup_s)
    info = [
        f"live: {N} frames at {rate} Hz in {window_s:.3f} s; solve frames "
        f"{len(solves)} ({100.0 * len(solves) / N:.1f}%); failed {failed}",
        f"live: latency p50 {metrics['frame_p50_ms']:.3f} p95 "
        f"{metrics['frame_p95_ms']:.3f} max {max(latency):.3f} ms; "
        f"late start p50 {report.median(lateness):.3f} p95 "
        f"{report.percentile(lateness, 95.0):.3f} max {max(lateness):.3f} ms",
        f"live: solve frames p50 "
        f"{report.median([latency[j] for j in solves]) if solves else 0:.3f} "
        f"ms; replays {replays}; captures in the window {captured}",
        f"live: ATE against the sweep {ate_rmse(est, truth) * 1e3:.3f} mm "
        f"over the window; setup {setup_s:.3f} s; peak {peak} bytes",
        f"check: {gaps.frames} frames, {gaps.solves} solves against the "
        f"reference in {ref_s:.3f} s: {gaps.numbers()}",
    ]
    if ctx.control:
        info.append(f"control: {ctl_gaps.numbers()}")
    layer = dict(profile=tracer.profile, ba_frames=set(solves),
                 untraced_wall_ms=[wall[j] for j in range(N - traced)
                                   if j not in set(solves)])
    if tracer.profile is not None:
        p = tracer.profile
        layer.update(p.fields())
    return Result(metrics, N, failed, gaps.numbers(), peak, layer, info,
                  ctl_gaps.numbers() if ctx.control else None)
