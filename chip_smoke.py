"""GPU smoke run of the PyTorch port (kbslam_torch) of kbslam.

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases (each prints one line or more; any failure raises and exits
non-zero):
  1. device   — require CUDA; print the card's name and power limit;
  2. build    — compile the port's CUDA kernels from kbslam_torch/csrc,
                one nvcc per source, in parallel;
  3. patches  — the patch-extraction kernel (the 1:1 counterpart of the
                TPU kernel) against its plain PyTorch twin at the
                tracking step's shapes (bit-equal), timed beside the
                twin and one PyTorch call (unfold and index) that
                computes the same patches;
  4. describe — the fused describe kernel (patch, IC angle and rBRIEF
                bits in shared memory) against its plain composition on
                the tracking shapes, an odd count, a tiny pyramid and the
                real keypoints of one synthetic 640x480 frame: angles
                within 2e-4 rad, equal bins and bits on every keypoint
                away from a bin's rounding edge, >= 99.9% bit-identical;
                timed beside the plain composition and the path it
                replaces (patch kernel + plain angle and bit stages);
  5. slice    — the tracking step (SLAM with local BA off) over a 60-frame
                640x480 synthetic RGB-D sequence at the default
                configuration; every frame launches the describe kernel
                once and the patch kernel never, tracks with >= 50
                inliers, and the trajectory error stays under 5 cm;
  6. ba       — one local BA at full width (window 5, 4096 compact
                observations and landmarks, 65,536 landmarks) on the map
                of that sequence at its fifth keyframe, against the same
                solve on the CPU: the same pruning and landmark
                references, final cost within 1e-3 of the CPU's and not
                above the initial one, poses within 1 mm and 0.05 deg
                after 3 LM trips (later trips walk a near-null valley of
                the plane scene, where rounding moves the endpoint; see
                ``ba_phase``); the solve runs under
                ``set_sync_debug_mode("error")``, so one host sync inside
                it fails the phase; prints device ms, kernel launches and
                host ms per solve;
  7. slam_ba  — the system's default path, SLAM with ``ba_mode=
                "on_keyframe"``, over the same 60 frames: the describe
                kernel once per frame, one solve per keyframe insertion,
                no solve raises its cost by more than 0.1%, every frame
                tracks with >= 50 inliers, ATE under 5 cm and the refined
                trajectory's within 1 mm of it or better; prints the
                median ms of frames with and without a solve;
  8. async    — the same 60 frames with ``ba_mode="async"`` (a captured
                solve replayed on a side stream, merged after an event
                poll), then ``finish()``: at least one merge, ATE under
                5 cm; prints the wall time of each frame that dispatched
                a solve;
  9. nk3      — the hard scene of tests/test_ba_in_loop.py (40 frames of
                320x240 spheres, 2 mm depth noise, 2% dropout,
                ``track_keyframes=3``) on seeds 0-2, BA off then on, held
                to that test's absolute gates; its relative gate (BA on
                <= 1.05 x BA off + 1 mm) is printed, not enforced;
 10. chunk    — the 60 frames through ``streaming.ChunkedStream`` with
                chunk 8 and BA off (7 replays of one captured CUDA graph
                of 8 steps, then 4 eager tail frames), three times, each
                run against the eager per-frame step on the card: equal
                success, keyframe and inlier counts, poses within 1e-5;
                the minimal sets of frames 0-7 equal on the CPU and the
                card; the eager step (after frame 0) and every dispatch
                after the capture run under sync debug mode "error"; a
                profiled replay runs the describe kernel once per frame
                of the chunk; prints graph launches, kernel nodes and
                kernel ms per chunk, host ms per dispatch, ms/frame and
                frames/s of each run, device busy share, peak device
                memory and ATE;
 11. chunk_async — the same with ``ba_mode="async"``: solves replay a
                captured local-BA graph on a side stream and merge
                chunk-late; every dispatched solve merged, tracking and
                ATE gates as in phase 8; the graphed solve bit-equal to
                the eager one on the final map; prints the host ms of
                the feeds that dispatched a solve and the solve's replay
                ms;
 12. checkpoint — a chunked run saved at frame 32 and resumed in a fresh
                stream: frames 32-59 equal phase 10's uninterrupted run.
Then one JSON line about the kernels, the nvidia-smi line, and the
result line. The describe kernel's launch count sums phases 5, 7 and
10. In phase 10 the wrapper's counter counts the eager calls (the
warm-up before the capture and the tail; a call inside the capture
launches nothing and is not counted), and the graph's replays, which no
Python runs, add the stream's replay count times the kernel's launches
in one replay, counted by torch.profiler.

Times: device time per call, from CUDA events around the replay of a
CUDA graph of 20 calls (so a wrapper's host time is not counted), and
for each kernel also back-to-back eager calls, host time included.
Bounds: the least time for a kernel's work at 3.35 TB/s of HBM and 67
TFLOP/s of float32 (H100 SXM), counting each input byte the run's data
needs once (the pyramid pixels the windows cover) and each output byte
once.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

FRAMES = 60
MIN_INLIERS = 50
MAX_ATE_M = 0.05       # the bound of tests/test_pipeline.py
ANGLE_TOL = 2e-4       # rad, the bound of tests/test_torch_frontend.py
EDGE_MARGIN = 1e-3     # bins: nearer a .5 edge the twin may round the other way
MIN_IDENTICAL = 0.999  # share of keypoints with all 256 bits equal
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
S = 40
BA_WINDOW = 5          # BAConfig.window: phase 6 solves a full window
CHUNK = 8              # frames per replay of the chunk graph (phases 10-12)


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def eager_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Milliseconds per call of back-to-back eager calls, by CUDA events
    after warm-up: the device's time or the host's, whichever is longer
    (a wrapper's Python and checks are the host's)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms(fn, iters: int = 20, replays: int = 10) -> float:
    """Device milliseconds per call: ``iters`` calls captured in one CUDA
    graph and replayed under CUDA events, so the host's time per call is
    not counted."""
    from kbslam_torch.device import graph_capture

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):      # warm-up: caches, allocator
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with graph_capture(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def patch_inputs(h, w, n, seed, dev):
    """A stacked [8, h, w] pyramid (level l in its top-left corner, as the
    frontend builds it) and n keypoint origins, a third at or past a
    level's far edge; clamped as kbslam_torch.frontend.brief does."""
    from kbslam_torch.frontend.image import pyramid_sizes

    rng = np.random.default_rng(seed)
    sizes = np.asarray(pyramid_sizes(h, w, 8, 1.2), np.int32)
    stacked = np.zeros((8, h, w), np.float32)
    for lv, (hl, wl) in enumerate(sizes):
        stacked[lv, :hl, :wl] = rng.random((hl, wl), np.float32) * 255
    level = rng.integers(0, 8, n).astype(np.int32)
    hw = sizes[level]
    xy = rng.random((n, 2)) * hw[:, ::-1]
    edge = rng.random(n) < 0.33
    xy[edge] = hw[edge, ::-1] - 1 + rng.integers(-3, 25, (edge.sum(), 2))
    base = np.round(xy).astype(np.int32)
    x0 = np.clip(base[:, 0] - 20, 0, np.maximum(hw[:, 1] - 40, 0))
    y0 = np.clip(base[:, 1] - 20, 0, np.maximum(hw[:, 0] - 40, 0))
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (stacked, level, y0.astype(np.int32), x0.astype(np.int32))]


def clamped_origins(stacked, level, y0, x0):
    L, H, W = stacked.shape
    return (level.long().clamp(0, L - 1), y0.long().clamp(0, H - S),
            x0.long().clamp(0, W - S))


def covered_bytes(stacked, level, y0, x0) -> int:
    """Bytes of pyramid the patches cover, each pixel counted once."""
    lv, y, x = clamped_origins(stacked, level, y0, x0)
    r = torch.arange(S, device=stacked.device)
    seen = torch.zeros(stacked.shape, dtype=torch.bool, device=stacked.device)
    seen[lv[:, None, None], (y[:, None] + r)[:, :, None],
         (x[:, None] + r)[:, None, :]] = True
    return int(seen.sum()) * stacked.element_size()


def bound(nbytes: float, flops: float = 0.0):
    """(bound_ms, bound_by) of a kernel's work on an H100 SXM."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def describe_check(got, ref):
    """The describe gates; returns the counts it printed and the angle
    error. Raises when a gate fails."""
    from kbslam_torch.frontend import brief

    (ga, gb), (ra, rb) = got, ref
    if ga.shape != ra.shape or gb.shape != rb.shape or gb.dtype != torch.uint8:
        raise AssertionError(f"describe shapes {ga.shape} {gb.shape} {gb.dtype}")
    if not torch.isfinite(ga).all() or int(gb.max()) > 1:
        raise AssertionError("describe: non-finite angle or a bit not in {0,1}")
    err = float((ga - ra).abs().max())
    frac = brief.angle_frac(ra).cpu().double().numpy()
    away = np.abs(frac - np.floor(frac) - 0.5) >= EDGE_MARGIN
    kbin = brief.angle_bins(ga.cpu()).numpy()   # the kernel's float32 ops
    rbin = brief.angle_bins(ra).cpu().numpy()   # the bins the twin used
    same = (gb == rb).all(1).cpu().numpy()
    counts = dict(n=len(same), near_edge=int((~away).sum()),
                  bin_diff=int((kbin != rbin).sum()),
                  bin_diff_away=int(((kbin != rbin) & away).sum()),
                  rows_diff=int((~same).sum()),
                  rows_diff_away=int((~same & away).sum()),
                  max_angle_err=err)
    if (err > ANGLE_TOL or counts["bin_diff_away"] or counts["rows_diff_away"]
            or same.mean() < MIN_IDENTICAL):
        raise AssertionError(f"describe kernel disagrees with its twin: {counts}")
    return counts


def real_frame_inputs(dev):
    """The describe call's inputs on one synthetic 640x480 frame, caught
    on their way through the frontend."""
    from kbslam_torch import config
    from kbslam_torch.frontend import orb
    from kbslam_torch.io import synthetic

    seq = synthetic.render_sequence(num_frames=2, height=480, width=640)
    caught = {}
    real = orb.describe_keypoints

    def catch(*args, **kwargs):
        caught["args"], caught["kwargs"] = args, kwargs
        return real(*args, **kwargs)

    orb.describe_keypoints = catch
    try:
        feats = orb.extract(torch.from_numpy(seq.rgb[1]).to(dev), None,
                            config.SLAMConfig().orb)
    finally:
        orb.describe_keypoints = real
    return caught["args"], caught["kwargs"]["radius"], int(feats.count())


def track(slam, seq):
    """``slam`` after it has processed every frame of ``seq``."""
    for i in range(len(seq.rgb)):
        slam.process(seq.rgb[i], seq.depth[i])
    return slam


def check_ba_run(slam, seq):
    """The gates of a SLAM run with local BA; returns (ATE, refined ATE)."""
    from kbslam_torch.eval import trajectory

    diags = slam.diagnostics
    bad = [d["frame"] for d in diags[1:]
           if not d["success"] or d["num_inliers"] < MIN_INLIERS]
    if bad:
        raise AssertionError(f"tracking failed or < {MIN_INLIERS} inliers "
                             f"on frames {bad}")
    inserted = sum(d["added_kf"] for d in diags)
    if slam.ba_mode == "on_keyframe" and len(slam.ba_stats) != inserted:
        raise AssertionError(f"{len(slam.ba_stats)} solves for {inserted} "
                             "keyframe insertions")
    for st in slam.ba_stats:
        if not st["final_cost"] <= 1.001 * st["initial_cost"]:
            raise AssertionError(f"a solve raised its cost: {st}")
    gt = seq.poses[:, :3, 3]
    ate = trajectory.ate_rmse(np.stack(slam.frame_poses)[:, :3, 3], gt)
    ate_ref = trajectory.ate_rmse(slam.refined_trajectory()[:, :3, 3], gt)
    if not (np.isfinite(ate_ref) and ate < MAX_ATE_M
            and ate_ref <= ate + 1e-3):
        raise AssertionError(f"ATE {ate} m, refined {ate_ref} m")
    return ate, ate_ref


def _angle_deg(qa, qb):
    """Rotation angles between unit quaternions [N, 4], in float64."""
    a = qa.double() / qa.double().norm(dim=-1, keepdim=True)
    b = qb.double() / qb.double().norm(dim=-1, keepdim=True)
    w = (a * b).sum(-1)
    v = (a[:, :1] * b[:, 1:] - b[:, :1] * a[:, 1:]
         - torch.linalg.cross(a[:, 1:], b[:, 1:]))
    return torch.rad2deg(2 * torch.atan2(v.norm(dim=-1), w.abs()))


def _pose_gap(a, b):
    """(max metres, max degrees) between the keyframe poses of two maps."""
    return (float((a.kf_t.cpu() - b.kf_t.cpu()).norm(dim=-1).max()),
            float(_angle_deg(a.kf_q.cpu(), b.kf_q.cpu()).max()))


def ba_phase(dev, seq, smi):
    """One full-width local BA on the card against the CPU (phase 6).

    The window (a textured plane) has a near-null pose/plane valley: the
    20-trip solve stops part-way along it, and float32 rounding moves
    where. So the poses are held to 1 mm and 0.05 deg after 3 LM trips,
    where the iterates do not yet depend on rounding, and the 20-trip
    solve by its pruning, landmark references and cost; its pose gap to
    the CPU is printed beside the CPU's own gap when the landmarks move
    by 1e-7 m."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from kbslam_torch import config
    from kbslam_torch.ba.local_ba import local_ba
    from kbslam_torch.mapping.state import MapState, device_copy
    from kbslam_torch.slam import SLAM

    slam = SLAM(config.SLAMConfig(), seq.K, ba_mode="disabled", device=dev)
    for i in range(len(seq.rgb)):
        slam.process(seq.rgb[i], seq.depth[i])
        if slam.num_keyframes == BA_WINDOW:
            break
    if slam.num_keyframes != BA_WINDOW:
        raise AssertionError(f"{slam.num_keyframes} keyframes in {FRAMES} "
                             "frames")
    m, cfg, intr = slam.state.map, slam.config.ba, slam.intr
    local_ba(device_copy(m), intr, cfg)     # warm-up: handles, allocator
    torch.cuda.synchronize()

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        start.record()
        out, stats = local_ba(m, intr, cfg)
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    stream_ms = start.elapsed_time(end)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        local_ba(m, intr, cfg)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in kernels) / 1e3
    graph_ms = cuda_ms(lambda: local_ba(m, intr, cfg), iters=1, replays=5)

    cpu_map = MapState(*(t.cpu() for t in m))
    ref, ref_stats = local_ba(cpu_map, intr, cfg)
    g = torch.Generator().manual_seed(0)
    nudged = cpu_map._replace(mp_pos=cpu_map.mp_pos + 1e-7 * torch.randn(
        cpu_map.mp_pos.shape, generator=g))
    cpu_gap = _pose_gap(local_ba(nudged, intr, cfg)[0], ref)
    cfg3 = dataclasses.replace(cfg, max_iterations=3)
    gap3 = _pose_gap(local_ba(m, intr, cfg3)[0], local_ba(cpu_map, intr, cfg3)[0])
    got = [x.cpu() for x in stats]
    init, final = float(got[0]), float(got[1])
    cpu_final = float(ref_stats.final_cost)
    gap = _pose_gap(out, ref)
    dp = float((out.mp_pos.cpu() - ref.mp_pos).abs().max())
    same = (int(got[4]) == int(ref_stats.num_pruned)
            and torch.equal(out.kf_mp.cpu(), ref.kf_mp))
    if not (same and gap3[0] <= 1e-3 and gap3[1] <= 0.05 and final <= init
            and abs(final - cpu_final) <= 1e-3 * abs(cpu_final)):
        raise AssertionError(
            f"local BA on the card != CPU: pruned {int(got[4])} vs "
            f"{int(ref_stats.num_pruned)}, kf_mp equal {same}, poses after 3 "
            f"trips {gap3}, cost {init} -> {final} (CPU {cpu_final})")
    print(f"[ba] window of {BA_WINDOW} keyframes at frame {i}, 640x480, "
          f"4096 compact obs/landmarks, 65536 landmarks: cost {init:.3f} -> "
          f"{final:.3f} (CPU {cpu_final:.3f}), {int(got[2])} iterations, "
          f"{int(got[3])} accepted, {int(got[4])} pruned (CPU "
          f"{int(ref_stats.num_pruned)}), kf_mp equal; poses after 3 trips "
          f"within {gap3[0]:.2e} m and {gap3[1]:.2e} deg of the CPU; after "
          f"20 trips {gap[0]:.2e} m and {gap[1]:.2e} deg (the CPU against "
          f"itself with the landmarks moved by 1e-7 m: {cpu_gap[0]:.2e} m and "
          f"{cpu_gap[1]:.2e} deg), points {dp:.2e} m; 0 host syncs in the "
          f"solve (sync debug mode 'error'); per solve: device "
          f"{graph_ms:.2f} ms (CUDA graph replay, CUDA events), stream "
          f"{stream_ms:.2f} ms (CUDA events around the eager call), kernel "
          f"time {busy_ms:.2f} ms and {len(kernels)} kernel launches "
          f"(torch.profiler), host {host_ms:.2f} ms; {smi}", flush=True)


def async_phase(dev, seq, smi):
    """ba_mode="async" over the sequence, then finish() (phase 8)."""
    from kbslam_torch import config
    from kbslam_torch.slam import SLAM

    slam = SLAM(config.SLAMConfig(), seq.K, ba_mode="async", device=dev)
    dispatch_ms = []
    for i in range(len(seq.rgb)):
        before = slam._async.inflight
        d = slam.process(seq.rgb[i], seq.depth[i])
        if (slam._async.inflight is not None
                and slam._async.inflight is not before):
            dispatch_ms.append((i, round(d["wall_ms"], 2)))
    merged = sum(d["ran_ba"] for d in slam.diagnostics)
    median = np.median([d["wall_ms"] for d in slam.diagnostics[1:]])
    slam.finish()
    ate, ate_ref = check_ba_run(slam, seq)
    if merged < 1:
        raise AssertionError("async BA merged no solve while tracking")
    if slam._async._graph is None:
        raise AssertionError("async BA ran no captured solve on the card")
    print(f"[async] {FRAMES} frames 640x480, ba_mode=async: "
          f"{len(slam.ba_stats)} solves, {merged} merged while tracking, "
          f"ATE {ate * 1e3:.2f} mm, refined {ate_ref * 1e3:.2f} mm; "
          f"(frame, ms) of the frames that dispatched a solve {dispatch_ms}; "
          f"median ms/frame {median:.2f}; {smi}", flush=True)


def nk3_phase(dev, smi):
    """The hard NK=3 scene of tests/test_ba_in_loop.py (phase 9)."""
    from kbslam_torch import config
    from kbslam_torch.eval import trajectory
    from kbslam_torch.io import synthetic
    from kbslam_torch.slam import SLAM

    cfg = config.SLAMConfig(
        image_height=240, image_width=320, track_keyframes=3,
        orb=config.OrbConfig(num_features=512, num_levels=4, max_features=512),
        pnp=config.PnPConfig(num_hypotheses=128),
        map=config.MapConfig(max_keyframes=16, max_map_points=8192))
    for seed in (0, 1, 2):
        seq = synthetic.render_sequence(
            num_frames=40, height=240, width=320, scene="spheres",
            depth_noise_mm=2.0, depth_dropout=0.02, seed=seed)
        gt = seq.poses[:, :3, 3]
        ate = {}
        for mode in ("disabled", "on_keyframe"):
            s = track(SLAM(cfg, seq.K, ba_mode=mode, use_mask=False,
                           device=dev), seq)
            ate[mode] = trajectory.ate_rmse(np.stack(s.frame_poses)[:, :3, 3],
                                            gt)
        succ = sum(d["success"] for d in s.diagnostics)
        ate_ref = trajectory.ate_rmse(s.refined_trajectory()[:, :3, 3], gt)
        off, on = ate["disabled"], ate["on_keyframe"]
        if not (succ >= 36 and len(s.ba_stats) >= 2 and on < 0.09
                and ate_ref < 0.05 and ate_ref <= on + 1e-3):
            raise AssertionError(
                f"nk3 seed {seed}: {succ} tracked, {len(s.ba_stats)} solves, "
                f"ATE on {on} m, refined {ate_ref} m")
        rel = on <= 1.05 * off + 1e-3
        print(f"[nk3] seed {seed}: {succ}/40 tracked, {len(s.ba_stats)} "
              f"solves, ATE BA off {off * 1e3:.2f} mm, on {on * 1e3:.2f} mm, "
              f"refined {ate_ref * 1e3:.2f} mm; relative gate on <= 1.05 x "
              f"off + 1 mm (printed, not enforced): "
              f"{'holds' if rel else 'misses'}; {smi}", flush=True)


def _stream(cs, seq, frames, sync_checked=False):
    """Feed ``frames`` of ``seq`` to the ChunkedStream ``cs`` and flush.
    Returns (results, a timing CUDA event recorded after each dispatch,
    host ms of each dispatch, [(frame, host ms)] of the feeds that
    dispatched a solve). An event completes when its chunk's work has,
    so the events' spacing is the chunks' pace on the device's clock,
    idle gaps included. With ``sync_checked`` every dispatch after the
    first (the first captures the graph) runs under sync debug mode
    "error"."""
    dispatch = cs._dispatch
    ends, host_ms = [], []

    def checked(n):
        first = cs._graph is None
        if sync_checked and not first:
            torch.cuda.set_sync_debug_mode("error")
        t = time.perf_counter()
        try:
            dispatch(n)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        host_ms.append((time.perf_counter() - t) * 1e3)
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()

    def inflight():
        return cs._async.inflight if cs._async is not None else None

    cs._dispatch = checked
    got, ba_feeds = [], []
    for i in frames:
        before = inflight()
        t = time.perf_counter()
        got += cs.feed(seq.rgb[i], seq.depth[i])
        if inflight() is not None and inflight() is not before:
            ba_feeds.append((i, round((time.perf_counter() - t) * 1e3, 2)))
    got += cs.flush()
    torch.cuda.synchronize()
    del cs._dispatch     # the method again, and no reference cycle
    return got, ends, host_ms, ba_feeds


def _same_results(got, ref, what):
    """The chunk gates: equal success, keyframe and inlier counts, poses
    within 1e-5. Returns the largest pose difference."""
    if len(got) != len(ref):
        raise AssertionError(f"{what}: {len(got)} results for {len(ref)}")
    worst = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        for k in ("success", "added_kf", "num_inliers"):
            if g[k] != r[k]:
                raise AssertionError(
                    f"{what}, frame {i}: {k} {g[k]} != {r[k]}")
        worst = max(worst, float(np.abs(g["pose_q"] - r["pose_q"]).max()),
                    float(np.abs(g["pose_t"] - r["pose_t"]).max()))
    if worst > 1e-5:
        raise AssertionError(f"{what}: poses differ by {worst}")
    return worst


def _replay_profile(graph):
    """One replay of ``graph`` under torch.profiler: (graph launches,
    kernels run, kernel ms, describe kernels run, describe kernel ms,
    the five kernels with the most device time as (name, count, ms))."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    events = prof.events()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    desc = [e for e in kernels if "describe" in e.name]
    launches = sum("GraphLaunch" in e.name for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU)
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name[:48], (0, 0.0))
        by_name[e.name[:48]] = (n + 1, t + e.device_time / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]
    return (launches, len(kernels), sum(e.device_time for e in kernels) / 1e3,
            len(desc), sum(e.device_time for e in desc) / 1e3,
            [(k, n, round(t, 2)) for k, (n, t) in top])


def chunk_phase(dev, seq, smi):
    """(10) The chunked streaming executor with ba_mode="off" against the
    eager per-frame path on the card. Returns (the chunked results, the
    describe launch count of the run)."""
    from kbslam_torch import config
    from kbslam_torch.eval import trajectory
    from kbslam_torch.geom.camera import Intrinsics
    from kbslam_torch.ops import describe as describe_ops
    from kbslam_torch.pipeline import init_state, make_track_step
    from kbslam_torch.pnp.ransac import hash_sampler
    from kbslam_torch.slam import output_to_host, pose_T
    from kbslam_torch.streaming import ChunkedStream

    cfg = config.SLAMConfig()
    intr = Intrinsics.from_matrix(seq.K)
    # the first frames' minimal sets: the same on the CPU and the card
    valid = (torch.arange(1024) % 3) != 0
    for f in range(8):
        fc = torch.tensor(f, dtype=torch.int32)
        a = hash_sampler(0, fc)(valid, valid, 32, 96, 6, False)
        b = hash_sampler(0, fc.to(dev))(valid.to(dev), valid.to(dev), 32, 96,
                                        6, False)
        if not all(torch.equal(x, y.cpu()) for x, y in zip(a, b)):
            raise AssertionError(f"minimal sets of frame {f}: CPU != card")

    # the eager per-frame path; the step after the first frame (which
    # builds the per-device constants) runs under sync debug mode "error"
    step = make_track_step(cfg, intr, use_mask=False, seed=0)
    state, ref = init_state(cfg, dev), []
    for i in range(FRAMES):
        rgb = torch.from_numpy(seq.rgb[i]).pin_memory().to(dev,
                                                           non_blocking=True)
        dep = torch.from_numpy(seq.depth[i].astype(np.int32)).pin_memory().to(
            dev, non_blocking=True)
        if i:
            torch.cuda.set_sync_debug_mode("error")
        try:
            state, out = step(state, rgb, dep)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        ref.append(output_to_host(out))

    # three runs, each in a fresh stream that captures its own graph:
    # the spread of the steady pace; peak memory is the first run's
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    full = FRAMES // CHUNK
    describe_ops.reset_launches()
    replays, paces, run_ms, peak_gb = 0, [], [], None
    for _ in range(3):
        cs = ChunkedStream(cfg, intr, init_state(cfg, dev), chunk=CHUNK)
        t0 = time.perf_counter()
        got, ends, host_ms, _ = _stream(cs, seq, range(FRAMES),
                                        sync_checked=True)
        run_ms.append((time.perf_counter() - t0) * 1e3 / FRAMES)
        replays += cs.replays
        if peak_gb is None:
            peak_gb = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
        worst = _same_results(got, ref, "chunked vs eager per-frame")
        # steady: chunks 2 to 7 on the device's clock, from the end of
        # the first (captured) chunk's work to the end of the last full
        # chunk's
        paces.append(ends[0].elapsed_time(ends[full - 1])
                     / ((full - 1) * CHUNK))
    eager_launches = describe_ops.launches
    if cs.replays != full:
        raise AssertionError(f"{cs.replays} graph replays for {full} chunks")
    est = np.stack([pose_T(r["pose_q"], r["pose_t"]) for r in got])
    ate = trajectory.ate_rmse(est[:, :3, 3], seq.poses[:, :3, 3])
    if not ate < MAX_ATE_M:
        raise AssertionError(f"chunked ATE {ate} m")
    # device figures of one chunk, from replays after the runs
    g_launch, nodes, kern_ms, n_desc, desc_ms, top = _replay_profile(
        cs._graph)
    if g_launch != 1 or n_desc != CHUNK:
        raise AssertionError(f"one replay: {g_launch} graph launches, "
                             f"{n_desc} describe kernels for {CHUNK} frames")
    launches = eager_launches + replays * n_desc
    replay_ms = eager_ms(cs._graph.replay, iters=3, warmup=1)
    ms_frame = float(np.median(paces))
    print(f"[chunk] {FRAMES} frames 640x480, chunk {CHUNK}, ba off: "
          f"{full} graph replays + {FRAMES - full * CHUNK} eager tail frames,"
          f" equal to the eager per-frame path (success, keyframes, inliers;"
          f" poses within {worst:.1e}); minimal sets of frames 0-7 equal on "
          f"CPU and card; 0 host syncs in the eager step after frame 0 and "
          f"in every dispatch after the capture (sync debug mode 'error'); "
          f"per chunk: {g_launch} graph launch, {nodes} kernel nodes, "
          f"{kern_ms:.2f} ms kernel time (torch.profiler), replay "
          f"{replay_ms:.2f} ms (CUDA events), host ms of the dispatch "
          f"(capture excluded) median {np.median(host_ms[1:full]):.3f} "
          f"(first, with warm-up and capture, {host_ms[0]:.1f}); describe "
          f"in the graph {n_desc} launches, {desc_ms:.4f} ms; steady "
          f"ms/frame of the three runs {[round(p, 3) for p in paces]} "
          f"(chunks 2-{full}, CUDA events), median {ms_frame:.3f} ms/frame, "
          f"{1e3 / ms_frame:.1f} frames/s; each whole run with capture and "
          f"tail {[round(r, 2) for r in run_ms]} ms/frame; device busy "
          f"{replay_ms / (ms_frame * CHUNK):.1%} of the median steady time "
          f"(ms of a replay alone / steady ms per chunk); peak device memory "
          f"above the sequence {peak_gb:.3f} GB (first run); describe "
          f"launches {launches} = {eager_launches} eager (warm-up and tail) "
          f"+ {replays} replays x {n_desc}; ATE {ate * 1e3:.2f} mm; "
          f"kernels with the most device time per chunk (name, count, ms) "
          f"{top}; {smi}", flush=True)
    return got, launches


def chunk_async_phase(dev, seq, smi):
    """(11) ba_mode="async" through the chunked executor: solves on a
    captured local-BA graph, merged chunk-late; and the graphed solve
    against the eager one on one window."""
    from kbslam_torch import config
    from kbslam_torch.ba.local_ba import GraphedLocalBA, local_ba
    from kbslam_torch.eval import trajectory
    from kbslam_torch.geom.camera import Intrinsics
    from kbslam_torch.pipeline import init_state
    from kbslam_torch.slam import pose_T, refine_frame_poses
    from kbslam_torch.streaming import ChunkedStream

    cfg = config.SLAMConfig()
    intr = Intrinsics.from_matrix(seq.K)
    cs = ChunkedStream(cfg, intr, init_state(cfg, dev), chunk=CHUNK,
                       ba_mode="async")
    dispatch, ba_host_ms = cs._async.dispatch, []

    def timed(live):  # host ms of the snapshot copy and the replay's enqueue
        t = time.perf_counter()
        dispatch(live)
        ba_host_ms.append(round((time.perf_counter() - t) * 1e3, 3))

    cs._async.dispatch = timed
    got, _, _, ba_feeds = _stream(cs, seq, range(FRAMES))
    del cs._async.dispatch
    inserted = sum(r["added_kf"] for r in got)
    gt = seq.poses[:, :3, 3]
    est = [pose_T(r["pose_q"], r["pose_t"]) for r in got]
    anchors = [(r["anchor_id"], pose_T(r["anchor_q"], r["anchor_t"]))
               for r in got]
    ate = trajectory.ate_rmse(np.stack(est)[:, :3, 3], gt)
    ate_ref = trajectory.ate_rmse(
        refine_frame_poses(est, anchors, cs.state.map)[:, :3, 3], gt)
    bad = [r["frame"] for r in got[1:]
           if not r["success"] or r["num_inliers"] < MIN_INLIERS]
    if (bad or not cs.ba_stats or len(cs.ba_stats) != len(ba_host_ms)
            or cs._async.inflight is not None
            or not (ate < MAX_ATE_M and ate_ref <= ate + 1e-3)):
        raise AssertionError(
            f"chunked async: failed frames {bad}, {len(ba_host_ms)} solves "
            f"dispatched, {len(cs.ba_stats)} merged, ATE {ate}, refined "
            f"{ate_ref}")
    for st in cs.ba_stats:
        if not st["final_cost"] <= 1.001 * st["initial_cost"]:
            raise AssertionError(f"a solve raised its cost: {st}")

    # the graphed solve against the eager one, on the final map
    m = cs.state.map
    eager = [local_ba(m, intr, cfg.ba) for _ in range(2)]
    g = GraphedLocalBA(cfg.ba, intr, m)
    g.snapshot(m)
    res, stats = g.solve()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(
        list(res) + list(stats), list(eager[0][0]) + list(eager[0][1])))
    repeat = all(torch.equal(a, b) for a, b in zip(eager[0][0], eager[1][0]))
    if not same:
        raise AssertionError(f"graphed solve != eager (eager repeats bit "
                             f"for bit: {repeat})")
    solve_ms = eager_ms(g.solve, iters=3, warmup=1)
    print(f"[chunk_async] {FRAMES} frames 640x480, chunk {CHUNK}, ba async: "
          f"{inserted} insertions, {len(cs.ba_stats)} solves dispatched and "
          f"merged (iterations {[s['iterations'] for s in cs.ba_stats]}), "
          f"ATE {ate * 1e3:.2f} mm, refined {ate_ref * 1e3:.2f} mm; host ms "
          f"of each solve's dispatch (snapshot copy + graph replay enqueue; "
          f"the first captures the graph) {ba_host_ms}; (frame, host ms) of "
          f"the feeds that dispatched one (they also wait for the previous "
          f"chunk's outputs) {ba_feeds}; graphed solve bit-equal to "
          f"the eager one on the final map (eager repeats bit for bit: "
          f"{repeat}), replay {solve_ms:.2f} ms (CUDA events); {smi}",
          flush=True)


def checkpoint_phase(dev, seq, ref, smi):
    """(12) Save the chunked stream's state at frame 32 and resume it in
    a fresh stream: frames 32-59 equal the uninterrupted run ``ref``."""
    import tempfile

    from kbslam_torch import config
    from kbslam_torch.geom.camera import Intrinsics
    from kbslam_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from kbslam_torch.pipeline import init_state
    from kbslam_torch.streaming import ChunkedStream

    cfg = config.SLAMConfig()
    intr = Intrinsics.from_matrix(seq.K)
    cs = ChunkedStream(cfg, intr, init_state(cfg, dev), chunk=CHUNK)
    first, _, _, _ = _stream(cs, seq, range(32))
    _same_results(first, ref[:32], "the first 32 frames")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        save_checkpoint(path, cs.state)
        state, _ = load_checkpoint(path, cfg, dev)
    if int(state.frame_count) != 32:
        raise AssertionError(f"resumed at frame {int(state.frame_count)}")
    resumed = ChunkedStream(cfg, intr, state, chunk=CHUNK)
    rest, _, _, _ = _stream(resumed, seq, range(32, FRAMES))
    worst = _same_results(rest, ref[32:], "resumed vs uninterrupted")
    print(f"[checkpoint] saved at frame 32, resumed in a fresh stream: "
          f"frames 32-{FRAMES - 1} equal to the uninterrupted run (poses "
          f"within {worst:.1e}); {smi}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from kbslam_torch import config
    from kbslam_torch.device import pick_device
    from kbslam_torch.eval import trajectory
    from kbslam_torch.frontend import brief
    from kbslam_torch.io import synthetic
    from kbslam_torch.ops import _build
    from kbslam_torch.ops import describe as describe_ops
    from kbslam_torch.ops import patches as patch_ops
    from kbslam_torch.profile_step import sync_sites
    from kbslam_torch.slam import SLAM

    # 1. device
    dev = pick_device()
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    print(f"[device] {name} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    built = _build.build()
    regs = [ln.strip() for ln in built.log.splitlines()
            if "registers" in ln or "Compiling entry" in ln]
    print(f"[build] {built.path.name} in {time.perf_counter() - t0:.2f} s "
          f"(cached={built.cached}) {' | '.join(regs)}", flush=True)

    # 3. the patch kernel against its plain twin and the one-call yardstick
    cases = [(480, 640, 3072), (480, 640, 3071), (64, 96, 130)]
    for h, w, n in cases:
        args = patch_inputs(h, w, n, seed=n, dev=dev)
        got = patch_ops.extract_patches(*args)
        ref = patch_ops.extract_patches_reference(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"patch kernel != plain twin at {h}x{w} n={n}")
    args = patch_inputs(480, 640, 3072, seed=0, dev=dev)
    st = args[0]
    lv, yy, xx = clamped_origins(*args)

    def unfold_call():
        return st.unfold(1, S, 1).unfold(2, S, 1)[lv, yy, xx]

    if not torch.equal(unfold_call(), patch_ops.extract_patches(*args)):
        raise AssertionError("unfold yardstick != patch kernel")
    p_plain = cuda_ms(lambda: patch_ops.extract_patches_reference(*args))
    p_ms = cuda_ms(lambda: patch_ops.extract_patches(*args))
    p_lib = cuda_ms(unfold_call)
    p_lib2 = cuda_ms(unfold_call)
    p_ms2 = cuda_ms(lambda: patch_ops.extract_patches(*args))
    p_plain2 = cuda_ms(lambda: patch_ops.extract_patches_reference(*args))
    p_eager = eager_ms(lambda: patch_ops.extract_patches(*args))
    n = args[1].shape[0]
    p_cov = covered_bytes(*args)
    p_bytes = p_cov + 3 * 4 * n + n * S * S * 4
    p_bound, p_by = bound(p_bytes)
    print(f"[patches] bit-equal to plain on {cases}; 3072 patches of "
          f"[8,480,640]: kernel {p_ms:.4f}/{p_ms2:.4f} ms, plain "
          f"{p_plain:.4f}/{p_plain2:.4f} ms, unfold+index "
          f"{p_lib:.4f}/{p_lib2:.4f} ms (device time, CUDA graph); eager "
          f"back-to-back kernel calls {p_eager:.4f} ms; bytes {p_bytes} "
          f"({p_cov} of pyramid "
          f"covered), bound {p_bound * 1e3:.2f} us by {p_by}, kernel at "
          f"{p_bound / p_ms:.1%} of it", flush=True)

    # 4. the fused describe kernel against its plain composition
    max_err = 0.0
    for h, w, n in cases:
        args = patch_inputs(h, w, n, seed=n, dev=dev)
        got = describe_ops.describe_keypoints(*args)
        torch.cuda.synchronize()
        counts = describe_check(got, describe_ops.describe_keypoints_reference(
            *args))
        max_err = max(max_err, counts["max_angle_err"])
        print(f"[describe] {h}x{w} {counts}", flush=True)
    real_args, radius, n_valid = real_frame_inputs(dev)
    got = describe_ops.describe_keypoints(*real_args, radius=radius)
    counts = describe_check(got, describe_ops.describe_keypoints_reference(
        *real_args, radius=radius))
    max_err = max(max_err, counts["max_angle_err"])
    print(f"[describe] one synthetic 640x480 frame through orb ({n_valid} "
          f"valid keypoints of {counts['n']}): {counts}", flush=True)

    args = patch_inputs(480, 640, 3072, seed=0, dev=dev)
    n = args[1].shape[0]

    def replaced_path():      # the patch kernel + the plain angle and bits
        patches = patch_ops.extract_patches(*args).reshape(n, S * S)
        angle = brief.ic_angles(patches, radius=15)
        return angle, brief.bits_from_patches(patches, angle)

    if not torch.equal(replaced_path()[1],
                       describe_ops.describe_keypoints_reference(*args)[1]):
        raise AssertionError("patch kernel path != plain describe")
    d_ms = cuda_ms(lambda: describe_ops.describe_keypoints(*args))
    d_plain = cuda_ms(lambda: describe_ops.describe_keypoints_reference(*args))
    d_old = cuda_ms(replaced_path)
    d_old2 = cuda_ms(replaced_path)
    d_plain2 = cuda_ms(lambda: describe_ops.describe_keypoints_reference(*args))
    d_ms2 = cuda_ms(lambda: describe_ops.describe_keypoints(*args))
    d_eager = eager_ms(lambda: describe_ops.describe_keypoints(*args))
    ref_bins = brief.angle_bins(describe_ops.describe_keypoints_reference(
        *args)[0])
    d_cov = covered_bytes(*args)
    table_bytes = int(torch.unique(ref_bins).numel()) * 256 * 2 * 2
    d_bytes = d_cov + 3 * 4 * n + table_bytes + n * (4 + 256)
    disc = int(((np.arange(S) - 20)[:, None] ** 2
                + (np.arange(S) - 20)[None, :] ** 2 <= 15 * 15).sum())
    d_flops = n * (4 * disc + 3 * 256)  # moments; 2 roundings + 1 subtract
    d_bound, d_by = bound(d_bytes, d_flops)
    print(f"[describe] 3072 keypoints of [8,480,640]: kernel "
          f"{d_ms:.4f}/{d_ms2:.4f} ms, plain {d_plain:.4f}/{d_plain2:.4f} ms, "
          f"replaced path (patch kernel + plain stages) {d_old:.4f}/"
          f"{d_old2:.4f} ms (device time, CUDA graph); eager back-to-back "
          f"kernel calls {d_eager:.4f} ms; bytes {d_bytes} ({d_cov} of "
          f"pyramid covered, "
          f"{table_bytes} of pair table, {n * 260} written), {d_flops} flop; "
          f"bound {d_bound * 1e3:.2f} us by {d_by}, kernel at "
          f"{d_bound / d_ms:.1%} of it", flush=True)

    # 5. the tracking slice at the default configuration
    seq = synthetic.render_sequence(num_frames=FRAMES, height=480, width=640)
    slam = SLAM(config.SLAMConfig(), seq.K, ba_mode="disabled", device=dev)
    torch.cuda.synchronize()
    patch_ops.reset_launches()
    describe_ops.reset_launches()
    t0 = time.perf_counter()
    walls = []
    for i in range(FRAMES):
        t1 = time.perf_counter()
        slam.process(seq.rgb[i], seq.depth[i])
        walls.append(time.perf_counter() - t1)
    total = time.perf_counter() - t0
    launches = {"describe_keypoints": describe_ops.launches,
                "extract_patches": patch_ops.launches}
    if launches != {"describe_keypoints": FRAMES, "extract_patches": 0}:
        raise AssertionError(f"kernel launches in {FRAMES} frames: {launches}")
    diags = slam.diagnostics
    bad = [d["frame"] for d in diags[1:]
           if not d["success"] or d["num_inliers"] < MIN_INLIERS]
    if bad:
        raise AssertionError(f"tracking failed or < {MIN_INLIERS} inliers "
                             f"on frames {bad}")
    est = np.stack(slam.frame_poses)
    ate = trajectory.ate_rmse(est[:, :3, 3], seq.poses[:, :3, 3])
    if not np.isfinite(est).all() or not ate < MAX_ATE_M:
        raise AssertionError(f"ATE {ate} m (bound {MAX_ATE_M})")
    steady = np.asarray(walls[1:]) * 1e3
    print(f"[slice] {FRAMES} frames 640x480, {slam.num_keyframes} keyframes, "
          f"min inliers {min(d['num_inliers'] for d in diags[1:])}, "
          f"ATE {ate * 1e3:.2f} mm, launches {launches}; "
          f"{FRAMES / total:.2f} FPS over all frames, median "
          f"{np.median(steady):.2f} ms/frame after the first "
          f"(first {walls[0] * 1e3:.1f} ms); {smi}", flush=True)
    # one more frame (the last again) with every host sync counted: the
    # upload goes through pinned buffers, so only the output copy waits
    sites = sync_sites(lambda: slam.process(seq.rgb[-1], seq.depth[-1]))
    if sum(sites.values()) != 1:
        raise AssertionError(f"host syncs in one SLAM.process: {sites}")
    print(f"[slice] host syncs in one SLAM.process: 1 ({dict(sites)}, the "
          f"output copy)", flush=True)

    # 6. one local BA at full width, on the card and on the CPU
    slice_launches = dict(launches)
    ba_phase(dev, seq, smi)

    # 7. the default path: a local BA after each keyframe insertion
    describe_ops.reset_launches()
    patch_ops.reset_launches()
    slam = track(SLAM(config.SLAMConfig(), seq.K, device=dev), seq)
    launches_ba = {"describe_keypoints": describe_ops.launches,
                   "extract_patches": patch_ops.launches}
    if launches_ba != {"describe_keypoints": FRAMES, "extract_patches": 0}:
        raise AssertionError(f"kernel launches with BA: {launches_ba}")
    ate, ate_ref = check_ba_run(slam, seq)
    diags = slam.diagnostics
    with_ba = [d["wall_ms"] for d in diags[1:] if d["ran_ba"]]
    without = [d["wall_ms"] for d in diags[1:] if not d["ran_ba"]]
    print(f"[slam_ba] {FRAMES} frames 640x480, ba_mode=on_keyframe: "
          f"{slam.num_keyframes} keyframes, {len(slam.ba_stats)} solves "
          f"(iterations {[s['iterations'] for s in slam.ba_stats]}, "
          f"pruned {[s['num_pruned'] for s in slam.ba_stats]}, solve ms "
          f"{[round(s['wall_ms'], 1) for s in slam.ba_stats]}), ATE "
          f"{ate * 1e3:.2f} mm, refined {ate_ref * 1e3:.2f} mm, min inliers "
          f"{min(d['num_inliers'] for d in diags[1:])}; median ms/frame "
          f"without a solve {np.median(without):.2f} ({len(without)} frames), "
          f"with one {np.median(with_ba):.2f} ({len(with_ba)} frames, after "
          f"the first); launches {launches_ba}; {smi}", flush=True)
    launches = {k: slice_launches[k] + launches_ba[k] for k in launches}

    # 8. asynchronous BA on a side stream
    async_phase(dev, seq, smi)

    # 9. the hard NK=3 scene of tests/test_ba_in_loop.py
    nk3_phase(dev, smi)

    # 10-12. the chunked streaming executor: one CUDA graph per chunk,
    # chunk-late async BA on a graphed solve, checkpoint and resume
    chunked, chunk_launches = chunk_phase(dev, seq, smi)
    launches["describe_keypoints"] += chunk_launches
    chunk_async_phase(dev, seq, smi)
    checkpoint_phase(dev, seq, chunked, smi)

    ref_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "kbslam") + os.sep
    loaded = [m for m, mod in list(sys.modules.items())
              if m == "jax" or m.startswith("jax.") or m == "kbslam"
              or m.startswith("kbslam.")
              or (getattr(mod, "__file__", None) or "").startswith(ref_dir)]
    if loaded:
        raise AssertionError(f"the port loaded JAX or kbslam/: {loaded}")

    print(json.dumps({"kernels": [
        {"name": "describe_keypoints", "route": "cuda",
         "source": "kbslam_torch/csrc/describe.cu",
         "replaces": "kbslam/ops/pallas_patches.py:153",
         "launches": launches["describe_keypoints"], "max_abs_err": max_err,
         "ms": d_ms, "plain_ms": d_plain, "bound_ms": d_bound,
         "bound_by": d_by, "library_ms": None},
        {"name": "extract_patches", "route": "cuda",
         "source": "kbslam_torch/csrc/patches.cu",
         "replaces": "kbslam/ops/pallas_patches.py:153",
         "launches": launches["extract_patches"], "max_abs_err": 0.0,
         "ms": p_ms, "plain_ms": p_plain, "bound_ms": p_bound,
         "bound_by": p_by, "library_ms": p_lib}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
