"""GPU smoke run of the PyTorch port (kbslam_torch) of kbslam.

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

and ``python3 chip_smoke.py --only distributed`` runs phase 22 after
only the phases it is held to (1, 2, phase 5's sequence, 7, 18 and 19),
for a machine with several cards; ``--only gates`` runs phase 23 after
phases 1 and 2, on phase 6's window; ``--only shell`` runs phases 5 and
7 after phases 1 and 2; ``--only multistream`` runs phases 4b and 19
after phases 1 and 2, with the kernels line of the batched describe
launch; ``--only chunked`` runs phases 14-18 after phases 1 and 2.

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
                4b. the same kernel over phase 19's shapes in one launch
                (8 pyramids, 8 x 3072 keypoints): bit-equal to 8 single
                launches, phase 4's gates against the twin, timed beside
                the twin and the 8 single launches;
  5. slice    — the tracking step (SLAM with local BA off) over a 60-frame
                640x480 synthetic RGB-D sequence at the default
                configuration, each frame one replay of the captured
                tracking step (whose profiled replay runs the describe
                kernel once; the patch kernel never runs); every frame
                tracks with >= 50 inliers, the trajectory error stays
                under 5 cm, the trajectory, diagnostics and map are
                bit-equal to tests/test_torch_slam_graph.py's drive of
                the eager functions over the same frames, and one more
                frame makes one host sync; prints the median ms per
                ``process`` call graphed and eager, graph launches per
                frame, capture seconds, a replay's kernels and peak
                device memory;
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
                "on_keyframe"``, over the same 60 frames, the tracking
                step and each solve a replayed graph: one tracking replay
                per frame, one solve replay per keyframe insertion, no
                solve raises its cost by more than 0.1%, every frame
                tracks with >= 50 inliers, ATE under 5 cm and the refined
                trajectory's within 1 mm of it or better; the
                trajectory, diagnostics, ``ba_stats`` and final map
                bit-equal to the same shell with its programs called
                eagerly (``eager_slam``); prints the median ms of
                frames with and without a solve, graphed and eager, host
                syncs and graph launches per frame, capture seconds and
                peak device memory;
  8. async    — the same 60 frames with ``ba_mode="async"`` (a captured
                solve replayed on a side stream, merged after an event
                poll), then ``finish()``: at least one merge, ATE under
                5 cm; prints the wall time of each frame that dispatched
                a solve;
  9. nk3      — the hard scene of tests/test_ba_in_loop.py (40 frames of
                320x240 spheres, 2 mm depth noise, 2% dropout,
                ``track_keyframes=3``) on seeds 0-2, BA off then on, held
                to that test's absolute gates; its relative gate (BA on
                <= 1.05 x BA off + 1 mm) is printed, not enforced: at
                these margins one frame's RANSAC basin decides it, and
                float32 rounding picks the basin (tests/
                test_torch_ba_in_loop.py);
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
                stream: frames 32-59 equal phase 10's uninterrupted run;
 13. loop     — the corridor out-and-back of tests/test_loop.py:206-261
                at 640x480 with ``SLAMConfig()``'s ORB, map and PnP and
                that test's policy and LoopConfig, loop off and on, BA
                after each keyframe: at least one verified loop, each
                against a keyframe >= 10 insertions older with >= 40
                inliers, and less endpoint drift with loops on; then the
                same scene at that test's own 320x240 configuration, held
                to its gates (off: 0 loops, drift > 5 cm; on: >= 3 loops,
                drift < 0.2 x off); prints per probe host ms, device ms
                and host syncs, per close launches and device ms; then
                one probe and one close on the card against the same
                calls on a CPU copy of the map, with the CPU's minimal
                sets: equal decisions, inliers within 1% + 1, relative
                pose, keyframes and landmarks within 1e-4;
 14. reloc    — lost-and-found of tests/test_loop.py:264-329 at 640x480
                (full-width ORB and map, that test's policy and reloc
                settings) per frame, held to that test's gates, and
                through ``ChunkedStream`` (chunk 4, graph replays) held
                to tests/test_loop.py:422-494's, its per-keyframe
                programs (cull, relocalization attempt) replayed as CUDA
                graphs and bit-equal to the same stream with
                ``graph=False`` (rows, events, state), every program call
                after the first under sync debug mode "error", two more
                attempts timed on each; prints per program its replays,
                captures, capture seconds and the host and device ms of
                a call graphed and eager; counts the describe launches of
                the relocalization attempts;
 15. chunk_loop — the 640x480 corridor through ``ChunkedStream`` (chunk
                8, async BA, loop closure and culling) against the same
                stream run eagerly (``graph=False``), both merging each
                solve at the next keyframe tick: equal results, at least
                one correction landing between replays, 0 host syncs in
                every dispatch after the capture: bit-equal rows, events
                and state, phase 14's program figures; prints steady
                ms/frame and the device busy share next to phase 10's;
 16. dense    — the monolithic TSDF volume at ``SLAMConfig()``'s
                ``DenseMapConfig`` (96x96x32 voxels) and 640x480:
                ``integrate`` of one frame of the plane sequence on the
                card against the CPU (weights equal and tsdf within 1e-6
                on every voxel whose projection, recomputed in float64,
                lies 1e-3 px or more from a .5 rounding edge, and on >=
                99.9% of all voxels); ``raycast`` at strides 1, 2 and 4,
                the card against the CPU at stride 4 (hit equal on >=
                99.9% of rays; depth within 1e-5 m and normals within 1e-4
                where both hit at the same step); each timed by a CUDA
                graph with its kernel launches, peak memory and bound;
                ``SLAM`` with BA on keyframe over the 60 frames (surface on
                the plane, median |z| < 2 cm; map consistency coverage >
                0.3, median error under a voxel; the mesh and its PLY
                round trip); ``ChunkedStream`` (chunk 8, BA off) against
                per-frame ``SLAM``, both dense (the same volume, the depth
                ring drained, no host sync in a dispatch or in a fusion
                after the first, which captures), and its integrate
                replayed against the same stream with ``graph=False``
                (bit-equal, phase 14's program figures); the volume
                through a checkpoint, bit-equal;
 17. submaps  — the submap atlas and dense ICP at ``SLAMConfig()``'s
                ``DenseMapConfig`` with 16 submaps (37.7 MB) and 640x480:
                ``start_submap`` and ``integrate_active`` on the card
                against the CPU by phase 16's voxel rule;
                ``align_depth_to_tsdf`` and ``align_depth_to_atlas`` (K = 3)
                on one frame of the plane from a perturbed pose (stride 4,
                8 trips), card against CPU (decisions equal, pose within
                0.1 mm and 0.01 deg, rmse within 1e-6 m, ``num_valid``
                within 0.5%), 0 host syncs in a solve, 8 + 1 launches of
                the fetch kernel of csrc/icp.cu in a solve, bit-equal to
                the plain twin on the card, each timed by a CUDA graph
                beside the twin, with launches, peak memory, the bound
                of slambench/harness/dense_bytes.icp_bytes and the fetch
                kernels' own time in a profiled replay; the atlas aligner
                again on the dense benchmark cell's ring (16 slots of
                512^3 voxels of 3/512 m, the window in the last three
                slots), bit-equal to the twin, 8 + 1 fetch launches a
                solve, timed beside the twin; ``SLAM`` with
                BA on keyframe and a submap every 2 insertions over the 60
                frames ((insertions + 1) // 2 submaps, surface on the
                plane, map consistency, a mesh); ``ChunkedStream`` (chunk
                8, BA off) against per-frame ``SLAM`` with the atlas (the
                same atlas to the bit, the ring drained, no host sync in a
                dispatch or in a fusion of either shell but a capture's
                entry), its submap start and fuse replayed against the
                same stream with ``graph=False`` (bit-equal, phase 14's
                program figures); the atlas through a checkpoint,
                bit-equal; the dense ICP rescue through the
                mask blackout of tests/test_dense_icp.py:118-163 at its
                320x240 and at 640x480 with ``SLAMConfig()``'s ORB and map,
                with the volume and with the atlas, held to that test's
                gates; one ``dense_icp="refine"`` pass over the 60 frames,
                its fetch kernels counted (capture warm-ups and graph
                replays, iters + 1 each);
 18. global_ba — BASELINE.json config 5 (200 cameras, 50,000 landmarks,
                102,400 observations, built as benchmarks/
                global_ba_stress.py:40-99 builds it): one guarded solve
                (4 LM rounds, PCG cap 25, tol 1e-2) on the card after a
                warm-up, under sync debug mode "error", against the same
                solve on the CPU (equal ``accepted`` and ``retries``, PCG
                trips within +-1 per round, the first round's cost within
                1e-3, both monotone to below 1e-2 of the start; later
                rounds' gaps printed beside the CPU's own under a 1e-7 m
                nudge), then captured and replayed bit-equal to the eager
                solve; prints device ms of a replay, kernel launches, host
                ms, peak memory, the landmark error and the live and
                masked PCG trips; then ``SLAM.run_global_ba`` on phase 7's
                map, three times from the same map (eager, the shape's
                first solve; the capture and a replay; a replay), each
                bit-equal to the eager solve (``run_global_ba_on_map(
                graph=False)``), with the host ms of each call and of the
                eager solve (monotone, the gauge keyframe bit-unchanged,
                the refined ATE beside phase 7's);
 19. multistream — BASELINE.json config 4: 8 streams of 640x480
                (``render_sequence`` seeds 0-7, 33 frames) at
                ``SLAMConfig()`` as one batched program: ``make_multistream_
                step`` (one CUDA graph per step over the stacked state, one
                describe kernel per replay, torch.profiler) and ``make_
                multistream_scan`` (apply_every 4, from frame 0's warm
                start, one graph per block of 4 frames, 4 describe kernels
                per replay; its replays bit-equal to its capture run): every
                stream tracked with >= 50 inliers after frame 0, >= 2
                keyframes per stream, each stream's ATE under 50 mm,
                tests/test_parallel.py:95-156's deferred-scan gates; then
                the per-stream yardstick (``make_perstream_step``/``_scan``,
                one graph per stream on side streams, then serially: the
                two bit-equal, streams 0 and 7 bit-equal to their
                single-stream runs, the same gates); prints, stream by
                stream, whether the batched run is bit-equal to the
                yardstick and where it first differs, with the largest
                position gap; ms per step and frames/s of both, kernel
                nodes per replay, describe launches, capture s, device
                busy share and peak memory, phase 10's single-stream pace
                beside them;
 20. longrun  — tests/test_longrun.py on the card: 200 palindrome frames
                of a 25-frame 120x160 sequence on a 6-keyframe,
                512-landmark map with async BA and culling, through
                ``SLAM`` and ``ChunkedStream`` (chunk 8), held to that
                test's gates; prints the ring wraps, solves merged and
                keyframes culled;
 21. io       — the reference's ingress and egress and the open
                end-to-end gates: ``kbslam_torch.cli`` per frame (60
                frames 640x480, ``--ba on --dense``) with ``--viewer
                rerun --viewer-every 1`` against ``--viewer none`` (equal
                trajectories and summaries; prints HAVE_RERUN, the median
                ms of a CLI iteration without a solve, host syncs per
                frame, the viewer's calls, one map readout's host ms, syncs
                and bytes, the stride-4 render's device ms by a CUDA graph
                of 20 calls); the CLI chunked (``--chunk 8 --dense``, with
                ``--ba async``, each solve merged at the next keyframe
                tick, and with ``--ba off``), viewer on against off (equal
                results; steady ms/frame and device busy share as in
                phase 10); the 60 frames through the raw wire codec
                (``_pack``, ``_unpack``) into ``SLAM``, bit-equal to phase
                5's trajectory; 16 frames through the ``FramePublisher``
                -> ``ZMQCamera`` -> CLI loopback, raw and, where protobuf
                is installed, proto, equal to the synthetic source's run
                (where pyzmq is missing, the line says so and the
                loopback is not run); ``utils.profiling.device_trace``
                around 4
                eager frames, whose trace holds 4 describe kernels;
                tests/test_slam.py::test_slam_end_to_end in both BA modes
                and the rotation-dominant sweep of tests/test_ba_in_loop.py
                (120 frames), with the port's own draws: every gate
                enforced but the sweep's relative one, which the CPU test
                holds on JAX's minimal sets and which is printed;
 22. distributed — the multi-device paths over one NCCL process per card
                (``kbslam_torch.parallel.dist.spawn``; a world of one
                on a one-card machine): config 5 camera-sharded and landmark-
                sharded, eagerly, bit-equal to phase 18's eager solve at
                world 1 and held to phase 18's gates against it at any
                world (host ms, device ms, collectives and bytes per solve
                and per PCG trip), each also captured with its NCCL
                collectives inside (``global_ba.replayed_global_solve``)
                and called three times (eager, capture, replay),
                bit-equal to the eager sharded solve on every rank, 0 collective calls from the host in a replay
                (host and device ms, compute and NCCL kernel ms);
                ``SLAM.run_global_ba(group=)`` on phase 7's map against
                phase 18's, three times from the same map, bit-equal to its
                eager run; config 4's 8 streams sharded
                over the ranks, immediate and deferred, each rank's block
                as one batched program (phase 19's tracking and deferred
                gates; prints whether each stream is bit-equal to phase
                19's batched run) and as one graph per stream (every
                stream bit-equal to phase 19's per-stream run, SHA-256 of
                its outputs and state), 0 collectives, frames/s and
                describe launches of both;
                phase 7's keyframes fused into a 512^3 volume in voxel
                slabs, gathered bit-equal to the unsharded ``integrate``
                on the card, 0 collectives, device ms and peak memory per
                card. Each rank loads no JAX;
 23. gates    — the dense reference solver (``ba/lm.py``) on phase 6's
                full-width window (65,536 landmarks, U [65536, 5, 6, 3]
                float32) under sync debug mode "error": after 3 and 20 LM
                trips against the card's compact solve (a layout that
                holds every active observation) with tests/test_ba.py:
                175-191's bounds (costs 1e-4 and 0.05, poses 1e-3,
                landmarks 5e-3 through ``uniq_global``), and against the
                same dense solve on the CPU with phase 6's (poses 1 mm and
                0.05 deg after 3 trips, the 20-trip cost within 1e-3);
                device ms as a replayed graph, launches, host ms, peak
                memory; then
                tests/test_pipeline.py's distorted-rendering, static-mask,
                range-aware rim and blank-frame gates at 240x320 through
                ``SLAM`` with the port's own draws, and the 640x480
                full system of tests/test_parity_vs_opencv.py:106 at
                ``SLAMConfig()`` (refined ATE under 8 mm, keyframe ATE
                within the CPU oracle's + 1 mm), every gate enforced, the
                describe kernel once per frame.
The dense stages, the atlas, global BA, the dense reference solver and
the multistream shell are plain torch, not kernels of the kernels line;
the aligners' fetches are the kernel of csrc/icp.cu, which replaces no
TPU kernel and enters the kernels line with phase 17's figures per
solve. Then one JSON line about the kernels, the nvidia-smi
line, and the result line. The describe kernel has two entries there:
its launches over one pyramid, which sum phases 5, 7 and 10, the
relocalization attempts of
phase 14, phase 16's dense SLAM run, phase 17's atlas SLAM run, phase
19's and phase 22's per-stream runs, phase 21's runs (its chunked CLI
runs add their replays x 8) and phase 23's runs; and its launches over
the 8 streams of config 4, phase 19's and phase 22's batched runs, with
phase 4b's figures. The wrapper's counter counts the eager calls (each
capture's warm-up, and in phase 10 the chunk's tail; a call inside a
capture launches nothing and is not counted), and the graphs' replays,
which no Python runs, add their replay counts times the kernel's
launches in one replay, counted by torch.profiler: one per replay of a
SLAM shell's tracking or relocalization graph (``describe_launches``),
eight per chunk replay, one per batched step replay and four per
batched block replay.

Times: device time per call, from CUDA events around the replay of a
CUDA graph of 20 calls (so a wrapper's host time is not counted), and
for each kernel also back-to-back eager calls, host time included.
Bounds: the least time for a kernel's work at 3.35 TB/s of HBM and 67
TFLOP/s of float32 (H100 SXM), counting each input byte the run's data
needs once (the pyramid pixels the windows cover) and each output byte
once.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
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


def reset_launch_counts() -> None:
    """Zero the describe wrapper's count and the shells' graph counts."""
    from kbslam_torch import device
    from kbslam_torch.ops import describe as describe_ops

    describe_ops.reset_launches()
    device.reset_counts()


def describe_launches() -> int:
    """Describe kernels launched since ``reset_launch_counts``: the
    wrapper's eager calls (each capture's warm-up among them) and one per
    replay of a SLAM shell's tracking or relocalization graph (a replay
    runs the kernel once: phase 5 profiles one; a call inside a capture
    launches nothing)."""
    from kbslam_torch import device
    from kbslam_torch.ops import describe as describe_ops

    return (describe_ops.launches + device.replays["track"]
            + device.replays["reloc"])


def check_shell_launches(what, frames) -> int:
    """The per-frame shell's launch gate since ``reset_launch_counts``:
    one replay of the tracking graph per frame, and eager describe calls
    only in the captures' warm-ups. Returns ``describe_launches()``."""
    from kbslam_torch import device
    from kbslam_torch.ops import describe as describe_ops

    warm = device.captures["track"] + device.captures["reloc"]
    if device.replays["track"] != frames or describe_ops.launches != warm:
        raise AssertionError(
            f"{what}: {device.replays['track']} tracking replays for "
            f"{frames} frames, {describe_ops.launches} eager describe calls "
            f"for {warm} captures")
    return describe_launches()


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


def track(slam, seq, masks=None):
    """``slam`` after it has processed every frame of ``seq``, each with
    its mask when ``masks`` is given."""
    for i in range(len(seq.rgb)):
        slam.process(seq.rgb[i], seq.depth[i],
                     None if masks is None else masks[i])
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


def _gap(ta, qa, tb, qb):
    """(max metres, max degrees) between two sets of poses."""
    return (float((ta.cpu() - tb.cpu()).norm(dim=-1).max()),
            float(_angle_deg(qa.cpu(), qb.cpu()).max()))


def _pose_gap(a, b):
    """_gap between the keyframe poses of two maps."""
    return _gap(a.kf_t, a.kf_q, b.kf_t, b.kf_q)


def eager_slam(*args, **kwargs):
    """A SLAM shell whose programs run eagerly on the card: the yardstick
    of its CUDA graphs (tests/test_torch_slam_graph.py holds the eager
    programs against a drive of the eager functions on the CPU)."""
    from kbslam_torch.slam import SLAM

    class EagerSLAM(SLAM):
        def _program(self, name, fn):
            return fn

    return EagerSLAM(*args, **kwargs)


_SAME_DIAG = ("frame", "success", "added_kf", "ran_ba", "inlier_ratio",
              "num_matches", "num_inliers", "num_features")


def same_run(got, ref) -> None:
    """Raise unless two shells' runs are bit-equal: frame poses,
    diagnostics, solve records (but their wall times), events, final
    state and dense model."""
    from kbslam_torch.device import tensor_leaves

    def diag(s):
        return [{k: d[k] for k in _SAME_DIAG} for d in s.diagnostics]

    def stats(s):
        return [{k: v for k, v in r.items() if k != "wall_ms"}
                for r in s.ba_stats]

    bad = [k for k, f in (
        ("poses", lambda s: np.stack(s.frame_poses).tobytes()),
        ("diagnostics", diag), ("ba_stats", stats),
        ("reloc_events", lambda s: s.reloc_events),
        ("loop_events", lambda s: s.loop_events),
        ("icp_events", lambda s: s.icp_events)) if f(got) != f(ref)]
    a = list(tensor_leaves((got.state, got.tsdf, got.atlas)))
    b = list(tensor_leaves((ref.state, ref.tsdf, ref.atlas)))
    if len(a) != len(b) or not all(torch.equal(x, y) for x, y in zip(a, b)):
        bad.append("state or dense model")
    if bad:
        raise AssertionError(f"graphed shell != eager shell: {bad}")


def _reset_peak() -> int:
    """Reset the peak-memory count; returns the bytes allocated now, the
    base that a peak is read above."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def timed_track(slam, seq):
    """``slam`` over ``seq``: host ms of each ``process`` call (upload
    included; each ends in the output copy, so the frame is done)."""
    walls = []
    for i in range(len(seq.rgb)):
        t = time.perf_counter()
        slam.process(seq.rgb[i], seq.depth[i])
        walls.append((time.perf_counter() - t) * 1e3)
    return walls


def _track_replay_profile(slam):
    """torch.profiler over one more replay of ``slam``'s tracking graph
    (on its last frame): (kernel nodes, kernel ms, describe kernels)."""
    (g,) = slam.graphs["track"].graphs.values()
    _, n, ms, n_desc, _, _ = _replay_profile(g.graph)
    return n, ms, n_desc


def _shell_figures(slam, frames):
    """Graph launches per frame, capture seconds per program and the
    programs' replays, from the shell's ``graphs``."""
    g = slam.graphs
    return (sum(x.replays for x in g.values()) / frames,
            {k: [round(c, 2) for c in x.capture_s] for k, x in g.items()},
            {k: x.replays for k, x in g.items()})


def batched_describe_phase(dev, smi):
    """(4b) The describe kernel over 8 pyramids of [8, 480, 640] and
    8 x 3072 keypoints in one launch (phase 19's shapes): bit-equal to 8
    single launches of it, held to phase 4's gates against the plain
    twin on the same inputs, timed beside the twin and the 8 single
    launches it replaces. Returns the kernels line's figures."""
    from kbslam_torch.frontend import brief
    from kbslam_torch.ops import describe as describe_ops

    parts = [patch_inputs(480, 640, 3072, seed=100 + i, dev=dev)
             for i in range(MS_STREAMS)]
    args = [torch.stack(x).contiguous() for x in zip(*parts)]
    got = describe_ops.describe_keypoints(*args)
    single = [describe_ops.describe_keypoints(*p) for p in parts]
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(single):
        if not (torch.equal(got[0][i], a) and torch.equal(got[1][i], b)):
            raise AssertionError(f"batched describe launch: stream {i} != "
                                 "its single launch")
    ref = describe_ops.describe_keypoints_reference(*args)
    counts = describe_check((got[0].reshape(-1), got[1].reshape(-1, 256)),
                            (ref[0].reshape(-1), ref[1].reshape(-1, 256)))
    print(f"[describe] {MS_STREAMS} x 3072 keypoints of [8,480,640] in one "
          f"launch: bit-equal to {MS_STREAMS} single launches; against the "
          f"twin {counts}", flush=True)

    def singles():
        return [describe_ops.describe_keypoints(*p) for p in parts]

    ms = cuda_ms(lambda: describe_ops.describe_keypoints(*args))
    plain = cuda_ms(lambda: describe_ops.describe_keypoints_reference(*args))
    s_ms = cuda_ms(singles)
    s_ms2 = cuda_ms(singles)
    plain2 = cuda_ms(lambda: describe_ops.describe_keypoints_reference(*args))
    ms2 = cuda_ms(lambda: describe_ops.describe_keypoints(*args))
    n = args[1].numel()
    bins = brief.angle_bins(ref[0])
    covered = sum(covered_bytes(*p) for p in parts)
    table_bytes = int(torch.unique(bins).numel()) * 256 * 2 * 2
    nbytes = covered + 3 * 4 * n + table_bytes + n * (4 + 256)
    disc = int(((np.arange(S) - 20)[:, None] ** 2
                + (np.arange(S) - 20)[None, :] ** 2 <= 15 * 15).sum())
    flops = n * (4 * disc + 3 * 256)
    b_ms, b_by = bound(nbytes, flops)
    print(f"[describe] {MS_STREAMS} x 3072 keypoints in one launch: kernel "
          f"{ms:.4f}/{ms2:.4f} ms, {MS_STREAMS} single launches "
          f"{s_ms:.4f}/{s_ms2:.4f} ms, plain twin {plain:.4f}/{plain2:.4f} "
          f"ms (device time, CUDA graph); bytes {nbytes} ({covered} of "
          f"pyramid covered, {table_bytes} of pair table, {n * 260} "
          f"written), {flops} flop; bound {b_ms * 1e3:.2f} us by {b_by}, "
          f"kernel at {b_ms / ms:.1%} of it; {smi}", flush=True)
    return dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=counts["max_angle_err"])


def slice_phase(dev, seq, smi):
    """(5) The tracking slice: SLAM with local BA off over the 60 frames,
    each frame one replay of the captured tracking step, held to the
    tracking gates and bit-equal to the eager shell (``eager_slam``) over
    the same frames, timed against it. Returns (the shell, the kernels' launch counts)."""
    from kbslam_torch import config
    from kbslam_torch.eval import trajectory
    from kbslam_torch.ops import patches as patch_ops
    from kbslam_torch.utils.profiling import sync_sites
    from kbslam_torch.slam import SLAM

    cfg = config.SLAMConfig()
    base = _reset_peak()
    reset_launch_counts()
    patch_ops.reset_launches()
    slam = SLAM(cfg, seq.K, ba_mode="disabled", device=dev)
    t0 = time.perf_counter()
    walls = timed_track(slam, seq)
    total = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    launches = {"describe_keypoints": check_shell_launches("slice", FRAMES),
                "extract_patches": patch_ops.launches}
    if launches["extract_patches"]:
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
    per_frame, capture_s, _ = _shell_figures(slam, FRAMES)
    base = _reset_peak()
    ref = eager_slam(cfg, seq.K, ba_mode="disabled", device=dev)
    eager_walls = timed_track(ref, seq)
    eager_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    same_run(slam, ref)
    # one more frame (the last again) with every host sync counted: the
    # upload goes through pinned buffers, so only the output copy waits
    sites = sync_sites(lambda: slam.process(seq.rgb[-1], seq.depth[-1]))
    if sum(sites.values()) != 1:
        raise AssertionError(f"host syncs in one SLAM.process: {sites}")
    nodes, kernel_ms, n_desc = _track_replay_profile(slam)
    if n_desc != 1:
        raise AssertionError(f"{n_desc} describe kernels in a replay of the "
                             "tracking graph")
    steady, eager = np.asarray(walls[1:]), np.asarray(eager_walls[1:])
    print(f"[slice] {FRAMES} frames 640x480, BA off, each frame one replay "
          f"of the captured tracking step: {slam.num_keyframes} keyframes, "
          f"min inliers {min(d['num_inliers'] for d in diags[1:])}, ATE "
          f"{ate * 1e3:.2f} mm; trajectory, diagnostics and map bit-equal to "
          f"the eager shell's; launches {launches} (the eager shell's "
          f"aside); {FRAMES / total:.2f} FPS over all frames; median "
          f"ms per process call after the first: graphed "
          f"{np.median(steady):.2f} (first {walls[0]:.1f} ms, the capture), "
          f"eager {np.median(eager):.2f}; graph launches per frame "
          f"{per_frame:.2f}; capture s {capture_s}; host syncs in one "
          f"process: 1 ({dict(sites)}, the output copy); a replay of the "
          f"tracking graph: {nodes} kernel nodes, {kernel_ms:.2f} ms of "
          f"kernel time, {n_desc} describe kernel (torch.profiler); peak "
          f"device memory above what was allocated before the run: graphed "
          f"{peak:.3f} GB, eager {eager_peak:.3f} GB; "
          f"{smi}", flush=True)
    return slam, launches


def default_path_phase(dev, seq, smi):
    """(7) The system's default path, SLAM with a local BA after each
    keyframe over the 60 frames, every program a replayed graph, against
    the eager shell (``eager_slam``): trajectory, diagnostics, ``ba_stats`` and the final
    map bit-equal. Returns (the shell, ATE, refined ATE, median ms of a
    frame without a solve, the kernels' launch counts)."""
    from kbslam_torch import config
    from kbslam_torch.ops import patches as patch_ops
    from kbslam_torch.utils.profiling import sync_sites
    from kbslam_torch.slam import SLAM

    cfg = config.SLAMConfig()
    base = _reset_peak()
    reset_launch_counts()
    patch_ops.reset_launches()
    slam = SLAM(cfg, seq.K, device=dev)
    holder = []
    sites = sync_sites(lambda: holder.append(timed_track(slam, seq)))
    walls = holder[0]
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    launches = {"describe_keypoints": check_shell_launches("default path",
                                                           FRAMES),
                "extract_patches": patch_ops.launches}
    if launches["extract_patches"]:
        raise AssertionError(f"kernel launches with BA: {launches}")
    ate, ate_ref = check_ba_run(slam, seq)
    per_frame, capture_s, replays = _shell_figures(slam, FRAMES)
    if replays.get("ba") != len(slam.ba_stats):
        raise AssertionError(f"{replays} replays for {len(slam.ba_stats)} "
                             "solves")
    base = _reset_peak()
    ref = eager_slam(cfg, seq.K, device=dev)
    eager_walls = timed_track(ref, seq)
    eager_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    same_run(slam, ref)
    diags = slam.diagnostics

    def split(ms):
        ba = [w for w, d in zip(ms[1:], diags[1:]) if d["ran_ba"]]
        plain = [w for w, d in zip(ms[1:], diags[1:]) if not d["ran_ba"]]
        return float(np.median(plain)), float(np.median(ba)), len(ba)

    g_plain, g_ba, n_ba = split(walls)
    e_plain, e_ba, _ = split(eager_walls)
    m = slam.state.map

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    map_bytes = nbytes(m)
    written = nbytes((m.kf_q, m.kf_t, m.mp_pos, m.kf_mp))
    print(f"[slam_ba] {FRAMES} frames 640x480, ba_mode=on_keyframe, every "
          f"program a replayed graph: {slam.num_keyframes} keyframes, "
          f"{len(slam.ba_stats)} solves (iterations "
          f"{[s['iterations'] for s in slam.ba_stats]}, pruned "
          f"{[s['num_pruned'] for s in slam.ba_stats]}), ATE "
          f"{ate * 1e3:.2f} mm, refined {ate_ref * 1e3:.2f} mm; trajectory, "
          f"diagnostics, ba_stats and final map bit-equal to the eager "
          f"shell's;"
          f" median ms per process call after the first, without a solve: "
          f"graphed {g_plain:.2f}, eager {e_plain:.2f}; with one ({n_ba} "
          f"frames): graphed {g_ba:.2f}, eager {e_ba:.2f} (first frame "
          f"{walls[0]:.1f} ms, its captures); solve host ms graphed "
          f"{[round(s['wall_ms'], 2) for s in slam.ba_stats]}; graph "
          f"launches per frame {per_frame:.2f} ({replays}); capture s "
          f"{capture_s}; host syncs per frame over the run "
          f"{sum(sites.values()) / FRAMES:.2f} ({dict(sites.most_common(4))});"
          f" the live map {map_bytes} bytes, of which the solve writes "
          f"{written} in place (4 tensors); peak device memory above what was allocated "
          f"before the run: graphed {peak:.3f} GB, eager {eager_peak:.3f} "
          f"GB; launches {launches}; {smi}",
          flush=True)
    return slam, ate, ate_ref, g_plain, launches


def shell_alone(dev, smi, name) -> int:
    """``--only shell``: phases 5 and 7 after phases 1-2."""
    from kbslam_torch.io import synthetic

    seq = synthetic.render_sequence(num_frames=FRAMES, height=480, width=640)
    slice_phase(dev, seq, smi)
    default_path_phase(dev, seq, smi)
    assert_no_jax()
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


def ba_window(dev, seq):
    """(SLAM with BA off over ``seq`` up to its fifth keyframe, the frame
    of that keyframe): the full window that phases 6 and 23 solve."""
    from kbslam_torch import config
    from kbslam_torch.slam import SLAM

    slam = SLAM(config.SLAMConfig(), seq.K, ba_mode="disabled", device=dev)
    for i in range(len(seq.rgb)):
        slam.process(seq.rgb[i], seq.depth[i])
        if slam.num_keyframes == BA_WINDOW:
            break
    if slam.num_keyframes != BA_WINDOW:
        raise AssertionError(f"{slam.num_keyframes} keyframes in {FRAMES} "
                             "frames")
    return slam, i


def ba_phase(dev, seq, smi):
    """One full-width local BA on the card against the CPU (phase 6);
    returns the SLAM that holds its window.

    The window (a textured plane) has a near-null pose/plane valley: the
    20-trip solve stops part-way along it, and float32 rounding moves
    where. So the poses are held to 1 mm and 0.05 deg after 3 LM trips,
    where the iterates do not yet depend on rounding, and the 20-trip
    solve by its pruning, landmark references and cost; its pose gap to
    the CPU is printed beside the CPU's own gap when the landmarks move
    by 1e-7 m."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from kbslam_torch.ba.local_ba import local_ba
    from kbslam_torch.mapping.state import MapState, device_copy

    slam, i = ba_window(dev, seq)
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
    return slam


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


def chunk_phase(dev, seq, smi, pace):
    """(10) The chunked streaming executor with ba_mode="off" against the
    eager per-frame path on the card. Returns (the chunked results, the
    describe launch count of the run); ``pace`` receives the steady
    ms/frame and the device busy share."""
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
    pace["ms_frame"], pace["busy"] = ms_frame, replay_ms / (ms_frame * CHUNK)
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


LOOP_GATES = dict(min_separation=10, score_min=0.7, min_inliers=40,
                  max_trans_disc=0.45, max_rot_disc_deg=15.0)


def corridor(height, width):
    """tests/test_loop.py:225-231's closed corridor (out and back), the
    focal length scaled with the width."""
    from kbslam_torch.io import synthetic

    out = synthetic.corridor_trajectory(40)
    poses = np.concatenate([out, out[::-1][1:]])
    return synthetic.render_sequence(
        num_frames=len(poses), height=height, width=width,
        fx=260.0 * width / 320, scene="corridor", depth_noise_mm=1.0, seed=2,
        poses=poses)


def corridor_config(loop_on, full, cull=False):
    """The corridor test's policy and LoopConfig over ``SLAMConfig()``
    (full: 640x480, its ORB, map and PnP) or that test's own 320x240
    ORB, map and PnP."""
    import dataclasses

    from kbslam_torch import config

    cfg = config.SLAMConfig(
        policy=config.KeyframePolicyConfig(min_frame_gap=3,
                                           rotation_threshold_deg=2.0),
        loop=config.LoopConfig(enabled=loop_on, **LOOP_GATES),
        cull=config.CullConfig(enabled=cull))
    if full:
        return cfg
    return cfg.replace(
        image_height=240, image_width=320,
        orb=config.OrbConfig(num_features=512, num_levels=4,
                             max_features=512),
        pnp=dataclasses.replace(cfg.pnp, num_hypotheses=128),
        map=config.MapConfig(max_keyframes=64, max_map_points=32768))


class _Timed:
    """Wraps a device function: host ms of each call (its enqueue) and
    CUDA events around it, read after the run."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        out = self.fn(*args, **kwargs)
        end.record()
        self.calls.append(((time.perf_counter() - t) * 1e3, start, end))
        return out

    def times(self):
        torch.cuda.synchronize()
        return ([round(h, 2) for h, _, _ in self.calls],
                [round(s.elapsed_time(e), 2) for _, s, e in self.calls])


def cuda_event_ms(fn, n: int = 3):
    """Milliseconds by CUDA events around each of ``n`` calls of ``fn``."""
    timed = _Timed(fn)
    for _ in range(n):
        timed()
    return timed.times()[1]


def run_corridor(dev, seq, cfg, timed=False):
    """SLAM with BA after each keyframe over the corridor: (shell,
    refined endpoint drift, the runner's probe and close timers)."""
    from kbslam_torch.slam import SLAM

    slam = SLAM(cfg, seq.K, ba_mode="on_keyframe", use_mask=False,
                device=dev)
    probe = close = None
    if timed and slam._loop is not None:
        probe = slam._loop._probe_cuda = _Timed(slam._loop._probe_cuda)
        close = slam._loop._close_cuda = _Timed(slam._loop._close_cuda)
    track(slam, seq)
    slam.finish()
    refined = slam.refined_trajectory()[:, :3, 3]
    return slam, float(np.linalg.norm(refined[-1] - refined[0])), probe, close


def _cpu_sets(ordinal):
    """The probe's minimal sets drawn on the CPU, moved to the tensors'
    device: the card and the CPU solve the same hypotheses."""
    from kbslam_torch.loop.detect import PROBE_SEED
    from kbslam_torch.pnp.ransac import hash_sampler

    inner = hash_sampler(PROBE_SEED, torch.tensor(ordinal, dtype=torch.int32))

    def sample(valid, pool, *rest):
        d, k = inner(valid.cpu(), None if pool is None else pool.cpu(), *rest)
        return d.to(valid.device), None if k is None else k.to(valid.device)
    return sample


def probe_close_vs_cpu(slam, dev):
    """One probe and one close on the card against the same calls on a
    CPU copy of the final map (phase 13). Returns the printed figures."""
    from torch.profiler import ProfilerActivity, profile

    from kbslam_torch.geom.se3 import SE3
    from kbslam_torch.device import CapturedCall
    from kbslam_torch.loop.closure import make_close_loop
    from kbslam_torch.loop.detect import make_loop_probe
    from kbslam_torch.loop.runner import LoopCloser
    from kbslam_torch.mapping.state import MapState
    from kbslam_torch.utils.profiling import sync_sites

    cfg, lc = slam.config, slam.config.loop
    m = slam.state.map
    m_cpu = MapState(*(t.cpu() for t in m))
    K = m.capacity_kf
    probe = make_loop_probe(cfg, slam.intr, sampler_for=_cpu_sets,
                            word_bits=lc.word_bits, **LOOP_GATES)

    def probe_on(mm, qid):
        i32 = dict(dtype=torch.int32, device=mm.kf_id.device)
        return probe(mm, torch.tensor(qid % K, **i32),
                     torch.tensor(qid, **i32), torch.tensor(qid + 1, **i32))

    # the newest closed query that still verifies on the corrected map
    for qid in [e["query_id"] for e in reversed(slam.loop_events)]:
        cc, kc = probe_on(m_cpu, qid)
        if bool(kc.ok):
            break
    else:
        raise AssertionError("no closed query verifies on the final map")
    cg, kg = probe_on(m, qid)
    ni_g, ni_c = int(kg.num_inliers), int(kc.num_inliers)
    dt = float((kg.rel_t.cpu() - kc.rel_t).abs().max())
    dq = float(_angle_deg(kg.rel_q.cpu()[None], kc.rel_q[None])[0])
    if not (bool(cg.found) == bool(cc.found) and bool(kg.ok) == bool(kc.ok)
            and bool(kc.ok) and int(cg.slot) == int(cc.slot)
            and abs(ni_g - ni_c) <= 0.01 * ni_c + 1 and dt <= 1e-4
            and np.radians(dq) <= 1e-4):
        raise AssertionError(
            f"probe card != CPU: found {bool(cg.found)}/{bool(cc.found)}, "
            f"ok {bool(kg.ok)}/{bool(kc.ok)}, slot {int(cg.slot)}/"
            f"{int(cc.slot)}, inliers {ni_g}/{ni_c}, rel {dt} m {dq} deg")

    # the close: the verified constraint moved by 5 cm and 2 deg, so the
    # solve moves every keyframe and landmark
    nudge = SE3.exp(torch.tensor([0.05, 0, 0, 0, np.radians(2.0), 0],
                                 dtype=torch.float32))
    rel = nudge.compose(SE3(kc.rel_q, kc.rel_t)).normalize()
    close = make_close_loop(lc.max_iterations, lc.loop_weight)
    out = {}
    for name, mm in (("card", m), ("cpu", m_cpu)):
        d = mm.kf_id.device
        out[name] = close(mm, cc.slot.to(d), torch.tensor(qid % K,
                                                          dtype=torch.int32,
                                                          device=d),
                          rel.q.to(d), rel.t.to(d),
                          torch.tensor(True, device=d))
    (mg, sg), (mc, sc) = out["card"], out["cpu"]
    gap_t = float((mg.kf_t.cpu() - mc.kf_t).abs().max())
    gap_q = float(_angle_deg(mg.kf_q.cpu(), mc.kf_q).max())
    gap_p = float((mg.mp_pos.cpu() - mc.mp_pos).abs().max())
    moved = float((mc.kf_t - m_cpu.kf_t).abs().max())
    if not (gap_t <= 1e-4 and gap_p <= 1e-4 and np.radians(gap_q) <= 1e-4
            and moved > 1e-3):
        raise AssertionError(f"close card != CPU: kf_t {gap_t}, kf_q "
                             f"{gap_q} deg, mp_pos {gap_p}, moved {moved}")
    # one probe's and one close's kernel launches and kernel time, and
    # the host syncs of a runner tick that probes and closes
    args = (m, cc.slot.to(dev), torch.tensor(qid % K, dtype=torch.int32,
                                             device=dev), rel.q.to(dev),
            rel.t.to(dev), torch.tensor(True, device=dev))

    def kernels(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ks = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        return len(ks), round(sum(e.device_time for e in ks) / 1e3, 3)

    close_kernels = kernels(lambda: close(*args))
    probe_kernels = kernels(lambda: probe_on(m, qid))
    # the runner's close on the card: the same close as one CUDA graph
    graphed = CapturedCall(close, *args)
    gm, gs = graphed(*args)
    em, es = close(*args)
    if not all(torch.equal(a, b) for a, b in zip(
            [gm.kf_q, gm.kf_t, gm.mp_pos, *gs], [em.kf_q, em.kf_t, em.mp_pos,
                                                 *es])):
        raise AssertionError("graphed close != eager close")
    replay_ms = cuda_event_ms(lambda: graphed(*args))
    runner = LoopCloser(cfg, slam.intr, num_kf=qid)
    runner.note_insertions()
    sites = sync_sites(lambda: runner.tick(slam.state, 0, None))
    if not all(k.startswith("/loop/runner.py") for k in sites):
        raise AssertionError(f"host syncs outside the runner's reads: {sites}")
    return dict(probe_inliers=(ni_g, ni_c), rel_gap=(dt, dq),
                close_gap=(gap_t, gap_q, gap_p), moved=moved,
                close_kernels=close_kernels, probe_kernels=probe_kernels,
                graphed_ms=replay_ms,
                tick_syncs=dict(sites), closed=len(runner.events))


def loop_phase(dev, smi):
    """(13) The corridor out-and-back with loop closure, per frame."""
    seq = corridor(480, 640)
    _, off, _, _ = run_corridor(dev, seq, corridor_config(False, True))
    slam, on, probe, close = run_corridor(dev, seq,
                                          corridor_config(True, True),
                                          timed=True)
    ev = slam.loop_events
    bad = [e for e in ev if e["query_id"] - e["cand_id"] < 10
           or e["inliers"] < 40]
    if not ev or bad or not on < off:
        raise AssertionError(f"corridor 640x480: {len(ev)} loops ({bad} "
                             f"below the gates), drift on {on} off {off}")
    p_host, p_dev = probe.times()
    c_host, c_dev = close.times()
    vs = probe_close_vs_cpu(slam, dev)
    print(f"[loop] corridor 640x480 ({len(seq.rgb)} frames, SLAMConfig() "
          f"ORB/map/PnP, the test's policy and LoopConfig, BA on keyframe): "
          f"{len(ev)} loops closed {[(e['query_id'], e['cand_id'], e['inliers']) for e in ev]}, "
          f"endpoint drift on {on * 1e3:.2f} mm, off {off * 1e3:.2f} mm; "
          f"{len(p_host)} probes: host ms {p_host}, stream ms (CUDA events "
          f"around the call) {p_dev}; {len(c_host)} closes: host ms "
          f"{c_host}, stream ms {c_dev}; "
          f"after the run, card vs CPU: probe inliers {vs['probe_inliers']}, "
          f"relative pose gap {vs['rel_gap'][0]:.2e} m {vs['rel_gap'][1]:.2e} "
          f"deg; close (keyframes moved {vs['moved']:.3f} m) gaps kf_t "
          f"{vs['close_gap'][0]:.2e} m, kf_q {vs['close_gap'][1]:.2e} deg, "
          f"mp_pos {vs['close_gap'][2]:.2e} m; (kernel launches, kernel ms) "
          f"by torch.profiler: one probe {vs['probe_kernels']} (with the "
          f"minimal sets drawn on the CPU), one eager close "
          f"{vs['close_kernels']}, the runner's close as one CUDA graph "
          f"(bit-equal to the eager one) {vs['graphed_ms']} ms by CUDA "
          f"events, its input copy included; "
          f"host syncs of one runner tick that "
          f"probes and closes ({vs['closed']} closed): {vs['tick_syncs']}; "
          f"{smi}", flush=True)

    seq = corridor(240, 320)
    s_off, off, _, _ = run_corridor(dev, seq, corridor_config(False, False))
    s_on, on, _, _ = run_corridor(dev, seq, corridor_config(True, False))
    ev = s_on.loop_events
    if (s_off.loop_events or not off > 0.05 or len(ev) < 3
            or any(e["query_id"] - e["cand_id"] < 10 for e in ev)
            or not on < 0.2 * off):
        raise AssertionError(f"corridor 320x240 gates: off {off} m "
                             f"({len(s_off.loop_events)} loops), on {on} m "
                             f"({len(ev)} loops)")
    print(f"[loop] corridor 320x240 (tests/test_loop.py's configuration): "
          f"off {off * 1e3:.2f} mm, 0 loops; on {on * 1e3:.2f} mm, "
          f"{len(ev)} loops; {smi}", flush=True)


def lost_and_found(T_back, height=480, width=640):
    """tests/test_loop.py:277-295: pan away, blank frames, pan back."""
    from scipy.spatial.transform import Rotation

    from kbslam_torch.io import synthetic

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
    seq = synthetic.render_sequence(
        num_frames=len(poses), height=height, width=width,
        fx=260.0 * width / 320, scene="spheres", seed=2, poses=poses)
    rgb, dep = seq.rgb.copy(), seq.depth.copy()
    rgb[22:25] = 0
    dep[22:25] = 0
    return seq, rgb, dep, poses


def lost_config(reloc_after):
    from kbslam_torch import config

    return config.SLAMConfig(
        policy=config.KeyframePolicyConfig(min_frame_gap=4),
        loop=config.LoopConfig(reloc_after=reloc_after, reloc_score_min=0.4,
                               reloc_min_inliers=30))


def tail_errors(est, poses, frames):
    T0_gt, T0_est = np.linalg.inv(poses[0]), np.linalg.inv(est[0])
    return np.array([np.linalg.norm((T0_est @ est[i])[:3, 3]
                                    - (T0_gt @ poses[i])[:3, 3])
                     for i in frames])


class _CountedReloc:
    """Wraps a shell's relocalization step (eager, or the per-frame
    shell's replayed graph): attempts, their describe launches, host ms
    and CUDA-event device ms."""

    def __init__(self, fn):
        self.fn, self.launches = fn, 0
        self.timed = _Timed(fn)

    def __call__(self, *args, **kwargs):
        before = describe_launches()
        out = self.timed(*args, **kwargs)
        self.launches += describe_launches() - before
        return out


class _Program(_Timed):
    """One of a ChunkedStream's per-keyframe programs (its LiveGraphs, or
    with ``graph=False`` the eager function) as the stream calls it: host
    ms and CUDA-event device ms of each call, the describe kernels it
    launched (``describe_launches``: a reloc replay runs one), and every
    call after the first under sync debug mode "error" (the first
    captures the graph, and torch's capture entry synchronizes the
    device; eagerly, it builds the per-device tables)."""

    def __init__(self, fn):
        super().__init__(fn)
        self.launches = 0

    def __call__(self, *args):
        before = describe_launches()
        mode = torch.cuda.get_sync_debug_mode()
        if self.calls:
            torch.cuda.set_sync_debug_mode("error")
        try:
            return super().__call__(*args)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
            self.launches += describe_launches() - before


_PROGRAMS = (("cull", "_cull"), ("reloc", "_relocalize"),
             ("integrate", "_integrate"), ("submap_start", "_submap_start"),
             ("submap_fuse", "_submap_fuse"))


def watch_programs(cs) -> dict:
    """Wrap each per-keyframe program of the ChunkedStream ``cs`` in a
    ``_Program``; returns them by name."""
    out = {}
    for name, attr in _PROGRAMS:
        fn = getattr(cs, attr, None)
        if fn is not None:
            out[name] = _Program(fn)
            setattr(cs, attr, out[name])
    return out


def program_rows(cs, graphed, eager) -> dict:
    """Per program of the graphed stream ``cs``: replays, captures and
    capture seconds, and the median host ms (enqueue) and device ms (CUDA
    events) of a call after the first, graphed (replays) and eager
    (``graph=False``), with the number of calls."""
    def med(x):
        return round(float(np.median(x[1:])), 3) if len(x) > 1 else None

    rows = {}
    for name, w in graphed.items():
        g = cs.graphs[name]
        (gh, gd), (eh, ed) = w.times(), eager[name].times()
        rows[name] = dict(
            replays=g.replays, captures=len(g.graphs),
            capture_s=[round(c, 2) for c in g.capture_s], calls=len(gh),
            host_ms=med(gh), eager_host_ms=med(eh), device_ms=med(gd),
            eager_device_ms=med(ed))
    return rows


def same_streams(a, b, what):
    """Raise unless two ChunkedStream runs ((stream, results)) are
    bit-equal: every output row, the relocalization and loop events, the
    final state and the volume or atlas."""
    from kbslam_torch.device import tensor_leaves

    (cs_a, got_a), (cs_b, got_b) = a, b
    if len(got_a) != len(got_b):
        raise AssertionError(f"{what}: {len(got_a)} results for "
                             f"{len(got_b)}")
    for i, (x, y) in enumerate(zip(got_a, got_b)):
        bad = [k for k in y if not np.array_equal(x[k], y[k])]
        if bad:
            raise AssertionError(f"{what}, frame {i}: {bad} differ")
    if (cs_a.reloc_events != cs_b.reloc_events
            or cs_a.loop_events != cs_b.loop_events):
        raise AssertionError(f"{what}: events differ")
    la = list(tensor_leaves((cs_a.state, cs_a.tsdf, cs_a.atlas)))
    lb = list(tensor_leaves((cs_b.state, cs_b.tsdf, cs_b.atlas)))
    if len(la) != len(lb) or not all(torch.equal(x, y)
                                     for x, y in zip(la, lb)):
        raise AssertionError(f"{what}: state or dense model differs")


def reloc_phase(dev, smi) -> int:
    """(14) Lost-and-found at 640x480, per frame and chunked. Returns the
    describe launches of the relocalization attempts."""
    from kbslam_torch.geom.camera import Intrinsics
    from kbslam_torch.pipeline import init_state
    from kbslam_torch.slam import SLAM, pose_T
    from kbslam_torch.streaming import ChunkedStream

    seq, rgb, dep, poses = lost_and_found(8)
    errs, shells = {}, {}
    for reloc_after in (0, 2):
        s = SLAM(lost_config(reloc_after), seq.K, use_mask=False, device=dev)
        if s._reloc is not None:
            s._reloc = _CountedReloc(s._reloc)
        for i in range(len(poses)):
            s.process(rgb[i], dep[i])
        errs[reloc_after] = tail_errors(s.frame_poses, poses,
                                        range(25, len(poses)))
        shells[reloc_after] = s
    s = shells[2]
    ev = s.reloc_events
    tail = [d["success"] for d in s.diagnostics[26:]]
    if (not ev or ev[0]["inliers"] < 30 or ev[0]["score"] < 0.4
            or not all(tail) or not errs[2].max() < 0.08
            or not errs[0].max() > 0.3):
        raise AssertionError(f"reloc per frame: events {ev}, tail {tail}, "
                             f"errors on {errs[2]} off {errs[0]}")
    pf = s._reloc
    pf_host, pf_dev = pf.timed.times()
    # one attempt on a lost frame and its read, with every host sync
    # counted: only the read may wait; eagerly on a copy of the final
    # state, then replayed on the shell's live state
    from kbslam_torch.loop.reloc import make_reloc_step, reloc_record
    from kbslam_torch.utils.profiling import sync_sites
    from kbslam_torch.slam import reloc_to_host
    from kbslam_torch.streaming import clone_state

    lc = s.config.loop
    step = make_reloc_step(s.config, s.intr, use_mask=False,
                           word_bits=lc.word_bits,
                           score_min=lc.reloc_score_min,
                           min_inliers=lc.reloc_min_inliers)
    frame = [torch.from_numpy(a).to(dev) for a in (rgb[27], dep[27].astype(
        np.int32))]
    step(clone_state(s.state), *frame)          # warm: per-device tables
    reloc_sites = sync_sites(lambda: reloc_to_host(step(
        clone_state(s.state), *frame, exclude_from_id=s._tracked_kf)[1],
        s.state.map))
    if sum(reloc_sites.values()) != 1 or not all(
            k.startswith("/slam.py") for k in reloc_sites):
        raise AssertionError(f"host syncs of one attempt: {reloc_sites}")
    live = s._upload(rgb[27], dep[27], None)
    exclude = s._load("reloc_exclude", s._tracked_kf, torch.int32)
    replay_sites = sync_sites(lambda: reloc_record(pf.fn(
        s.state, *live, exclude).cpu().numpy()))
    if sum(replay_sites.values()) != 1:
        raise AssertionError(f"host syncs of one replayed attempt: "
                             f"{replay_sites}")
    # describe_launches counts one kernel per replay of the reloc graph
    (g,) = pf.fn.graphs.values()
    _, reloc_nodes, reloc_kernel_ms, reloc_desc, _, _ = _replay_profile(g.graph)
    if reloc_desc != 1:
        raise AssertionError(f"{reloc_desc} describe kernels in a replay of "
                             "the reloc graph")

    # chunked, the per-keyframe programs replayed, against the same
    # stream with graph=False; then two more attempts on each, timed
    seq, rgb, dep, poses = lost_and_found(11)
    cfg = lost_config(2)
    runs, progs = {}, {}
    for graph in (True, False):
        cs = ChunkedStream(cfg, Intrinsics.from_matrix(seq.K),
                           init_state(cfg, dev), chunk=4, graph=graph)
        progs[graph] = watch_programs(cs)
        got = []
        for i in range(len(poses)):
            got += cs.feed(rgb[i], dep[i])
        got += cs.flush()
        runs[graph] = (cs, got)
    same_streams(runs[True], runs[False], "chunked reloc graphed vs eager")
    for graph in (True, False):
        cs = runs[graph][0]
        for _ in range(2):
            cs._attempt(cs._probe_frame[1])
    (cs, got), ch = runs[True], progs[True]["reloc"]
    cev = cs.reloc_events
    if not cev or cs.replays < 1:
        raise AssertionError(f"chunked reloc: events {cev}, replays "
                             f"{cs.replays}")
    recover_by = cev[0]["frame"] + 2 * 4
    tail = [r["success"] for r in got if r["frame"] >= recover_by]
    est = [pose_T(r["pose_q"], r["pose_t"]) for r in got]
    cerr = tail_errors(est, poses, range(recover_by, len(poses)))
    if (len(got) != len(poses) or cev[0]["inliers"] < 30
            or cev[0]["score"] < 0.4 or not tail or not all(tail)
            or not cerr.max() < 0.08):
        raise AssertionError(f"chunked reloc: events {cev}, tail {tail}, "
                             f"errors {cerr}")
    ch_host, ch_dev = ch.times()
    eager = progs[False]["reloc"]
    e_host, e_dev = eager.times()
    rows = program_rows(cs, progs[True], progs[False])
    print(f"[reloc] lost-and-found 640x480 (SLAMConfig() ORB/map, the test's "
          f"policy and reloc settings): per frame {len(ev)} relocalizations "
          f"{ev}, tail error max {errs[2].max() * 1e3:.2f} mm (off "
          f"{errs[0].max() * 1e3:.1f} mm), {len(pf_host)} attempts host ms "
          f"{pf_host} device ms {pf_dev}, describe launches {pf.launches}, "
          f"host syncs of one attempt and its read {dict(reloc_sites)}, of "
          f"one replayed attempt and its read {sum(replay_sites.values())}; "
          f"a replay of the reloc graph: {reloc_nodes} kernel nodes, "
          f"{reloc_kernel_ms:.2f} ms of kernel time, {reloc_desc} describe "
          f"kernel (torch.profiler); "
          f"chunked (chunk 4, {cs.replays} replays) {cev}, tail from frame "
          f"{recover_by} all tracked, error max {cerr.max() * 1e3:.2f} mm, "
          f"bit-equal to the stream with graph=False (rows, events, state); "
          f"its attempts (the run's, then 2 more) as a replayed graph host "
          f"ms {ch_host} device ms {ch_dev}, eagerly host ms {e_host} device "
          f"ms {e_dev}, describe launches {ch.launches} graphed and "
          f"{eager.launches} eager; every program call after the first 0 "
          f"host syncs (sync debug mode 'error'); per program {rows}; "
          f"{smi}", flush=True)
    return pf.launches + ch.launches + eager.launches


def chunk_loop_phase(dev, smi, pace):
    """(15) The 640x480 corridor through ChunkedStream (chunk 8, async BA,
    loop closure, culling), replayed against the same stream run
    eagerly."""
    from kbslam_torch import device
    from kbslam_torch.geom.camera import Intrinsics
    from kbslam_torch.pipeline import init_state
    from kbslam_torch.streaming import ChunkedStream

    seq = corridor(480, 640)
    cfg = corridor_config(True, True, cull=True)
    intr = Intrinsics.from_matrix(seq.K)
    runs, progs = {}, {}
    for graph in (False, True):
        cs = ChunkedStream(cfg, intr, init_state(cfg, dev), chunk=CHUNK,
                           ba_mode="async", graph=graph)
        progs[graph] = watch_programs(cs)
        # merge each solve at the next keyframe tick (waiting for it), so
        # both runs merge at the same drained frames
        cs._async.ready = lambda cs=cs: cs._async.inflight is not None
        at_close = []
        close = cs._loop._close_cuda

        def counted(*args, cs=cs, at_close=at_close, close=close):
            at_close.append(cs.replays)
            return close(*args)

        cs._loop._close_cuda = counted
        # the process's graph captures so far, at each dispatch: a chunk
        # interval with a capture in it (the probe's, a close's, once per
        # process) is left out of the steady pace
        caps, dispatch = [], cs._dispatch

        def at_dispatch(n, caps=caps, dispatch=dispatch):
            caps.append(sum(device.captures.values()))
            dispatch(n)

        cs._dispatch = at_dispatch
        got, ends, host_ms, _ = _stream(cs, seq, range(len(seq.rgb)),
                                        sync_checked=graph)
        cs._loop._close_cuda = close
        del cs._async.ready
        runs[graph] = (got, ends, host_ms, at_close, cs, caps)
    (ref, _, _, _, ref_cs, _), (got, ends, host_ms, at_close, cs, caps) = (
        runs[False], runs[True])
    same_streams((cs, got), (ref_cs, ref), "chunked loop vs eager stream")
    rows = program_rows(cs, progs[True], progs[False])
    between = [r for r in at_close if 1 <= r < cs.replays]
    if not between:
        raise AssertionError(f"no correction between replays: closes at "
                             f"replays {at_close} of {cs.replays}")
    full = len(seq.rgb) // CHUNK
    all_ms = ends[0].elapsed_time(ends[full - 1]) / ((full - 1) * CHUNK)
    clean = [ends[i - 1].elapsed_time(ends[i]) for i in range(1, full)
             if caps[i] == caps[i - 1]]
    ms_frame = sum(clean) / (len(clean) * CHUNK) if clean else all_ms
    # a cull on a copy of the final map, every host sync counted
    from kbslam_torch.mapping.cull import make_cull
    from kbslam_torch.mapping.state import device_copy
    from kbslam_torch.utils.profiling import sync_sites

    cull = make_cull(cfg.cull)
    cull(device_copy(cs.state.map))
    cull_sites = sync_sites(lambda: cull(device_copy(cs.state.map)))
    if cull_sites:
        raise AssertionError(f"host syncs in a cull: {cull_sites}")
    replay_ms = eager_ms(cs._graph.replay, iters=3, warmup=1)
    print(f"[chunk_loop] corridor 640x480, chunk {CHUNK}, ba async, loop and "
          f"cull on: {len(cs.loop_events)} loops closed (at replays "
          f"{at_close} of {cs.replays}; {len(between)} between replays), "
          f"{len(cs.ba_stats)} solves; bit-equal to the stream with "
          f"graph=False (rows, events, state); 0 host syncs in every "
          f"dispatch after the capture and every program call after the "
          f"first; per program {rows}; host ms per dispatch median "
          f"{np.median(host_ms[1:full]):.3f}; steady {ms_frame:.3f} ms/frame "
          f"({len(clean)} of chunks 2-{full}, those without a graph capture "
          f"in them; {all_ms:.3f} over all {full - 1}; CUDA events, probes "
          f"and closes included), "
          f"device busy {replay_ms / (ms_frame * CHUNK):.1%}; phase 10 (loop "
          f"off, plane): {pace['ms_frame']:.3f} ms/frame, busy "
          f"{pace['busy']:.1%}; 0 host syncs in a cull; {smi}", flush=True)


DENSE_TOL = 1e-6        # tsdf, card vs CPU and chunked vs per frame
DENSE_EDGE_PX = 1e-3    # px: nearer a .5 edge the card may round the other way
DENSE_AGREE = 0.999     # share of voxels, and of rays, that must agree


def _pose_qt(T):
    """(q, t) float32 numpy of a 4x4 pose."""
    from scipy.spatial.transform import Rotation

    x, y, z, w = Rotation.from_matrix(T[:3, :3]).as_quat()
    return (np.array([w, x, y, z], np.float32),
            np.asarray(T[:3, 3], np.float32))


def _near_round_edge(dcfg, intr, q, t):
    """[V] bool: voxels whose projected u or v, recomputed in float64,
    lie within DENSE_EDGE_PX of a .5 rounding edge."""
    from scipy.spatial.transform import Rotation

    axes = [dcfg.origin[a] + (np.arange(n) + 0.5) * dcfg.voxel_size
            for a, n in enumerate(dcfg.dims)]
    X = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    R = Rotation.from_quat([q[1], q[2], q[3], q[0]]).as_matrix()
    Xc = (X - t.astype(np.float64)) @ R
    z = np.where(Xc[:, 2] > 0, Xc[:, 2], 1.0)
    near = np.zeros(len(X), bool)
    for f, c, k in ((intr.fx, intr.cx, 0), (intr.fy, intr.cy, 1)):
        p = f * Xc[:, k] / z + c
        near |= np.abs(p - np.floor(p) - 0.5) < DENSE_EDGE_PX
    return near


def _launches(fn, name=""):
    """CUDA kernels that one call of ``fn`` runs (torch.profiler), those
    whose name holds ``name`` when one is given."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA
               and name in e.name for e in prof.events())


def _graph_kernels(fn, name):
    """One call of ``fn`` captured in a CUDA graph, and one replay of it
    under torch.profiler: (device ms of the kernels whose name holds
    ``name``, their count)."""
    from torch.profiler import ProfilerActivity, profile

    from kbslam_torch.device import graph_capture

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm-up: caches, allocator
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with graph_capture(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    ks = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and name in e.name]
    return sum(e.device_time for e in ks) / 1e3, len(ks)


def _peak_gb(fn):
    """Peak device memory of one call of ``fn`` above what was allocated
    before it, in GB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e9


def checked_after_first(fn, calls):
    """``fn`` with every call after the first under sync debug mode
    "error" (the first captures the stream's fusion graphs, and torch's
    capture entry synchronizes the device); each call appends its
    arguments to ``calls``."""
    def run(*args):
        if calls:
            torch.cuda.set_sync_debug_mode("error")
        try:
            fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        calls.append(args)
    return run


def dense_phase(dev, seq, smi, pace) -> int:
    """(16) The monolithic TSDF volume at SLAMConfig()'s DenseMapConfig
    (96x96x32 voxels) and 640x480: integrate and raycast on the card
    against the CPU, timed beside their bounds; SLAM with BA on keyframe
    and dense fusion; ChunkedStream (chunk 8, BA off) against per-frame
    SLAM; a checkpoint of the volume. Returns the describe launches of
    the dense SLAM run, and keeps its median ms of keyframe frames in
    ``pace``."""
    import dataclasses
    import tempfile

    from kbslam_torch import config, convert
    from kbslam_torch.geom.camera import Intrinsics
    from kbslam_torch.io.checkpoint import load_checkpoint_tsdf, save_checkpoint
    from kbslam_torch.mapping import dense, mesh, raycast
    from kbslam_torch.pipeline import init_state
    from kbslam_torch.utils.profiling import sync_sites
    from kbslam_torch.slam import SLAM
    from kbslam_torch.streaming import ChunkedStream

    base = config.SLAMConfig()
    cfg = base.replace(dense=dataclasses.replace(base.dense, enabled=True))
    dcfg, scale = cfg.dense, cfg.map.depth_scale
    intr = Intrinsics.from_matrix(seq.K)
    H, W = seq.depth.shape[1:]
    V = int(np.prod(dcfg.dims))
    fuse = dense.make_integrate(dcfg, intr, scale)
    P0 = np.linalg.inv(seq.poses[0])     # the SLAM gauge: camera 0

    # 1. integrate: frames 0, 10, 20 fused on the CPU, then frame 30 on
    # the card and on the CPU from that volume
    cpu = torch.device("cpu")
    vol = dense.empty_tsdf(dcfg, cpu)
    for i in (0, 10, 20):
        q, t = _pose_qt(P0 @ seq.poses[i])
        vol = fuse(vol, torch.from_numpy(seq.depth[i].astype(np.int32)),
                   torch.from_numpy(q), torch.from_numpy(t))
    q, t = _pose_qt(P0 @ seq.poses[30])
    dep = seq.depth[30].astype(np.int32)
    ref = fuse(vol, torch.from_numpy(dep), torch.from_numpy(q),
               torch.from_numpy(t))
    vol_d = convert.tsdf_to_torch(convert.tsdf_to_numpy(vol), dev)
    dep_d = torch.from_numpy(dep).to(dev)
    q_d, t_d = torch.from_numpy(q).to(dev), torch.from_numpy(t).to(dev)
    got = fuse(vol_d, dep_d, q_d, t_d)
    torch.cuda.synchronize()
    w_eq = (got.weight.cpu() == ref.weight).numpy().reshape(-1)
    t_ok = ((got.tsdf.cpu() - ref.tsdf).abs() <= DENSE_TOL).numpy().reshape(-1)
    agree = w_eq & t_ok
    away = ~_near_round_edge(dcfg, intr, q, t)
    if not (agree[away].all() and agree.mean() >= DENSE_AGREE):
        raise AssertionError(
            f"integrate card != CPU: {int((~agree).sum())} voxels of {V} "
            f"disagree, {int((~agree & away).sum())} away from a rounding "
            f"edge")
    in_ms = cuda_ms(lambda: fuse(vol_d, dep_d, q_d, t_d))
    in_eager = eager_ms(lambda: fuse(vol_d, dep_d, q_d, t_d))
    in_launches = _launches(lambda: fuse(vol_d, dep_d, q_d, t_d))
    in_peak = _peak_gb(lambda: fuse(vol_d, dep_d, q_d, t_d))
    in_bytes = 4 * V * 4 + H * W * 4    # tsdf, weight read and written; depth
    in_bound, in_by = bound(in_bytes, 50.0 * V)
    print(f"[dense] integrate {dcfg.dims} = {V} voxels, 640x480 depth: card "
          f"equal to the CPU on {agree.mean():.6f} of voxels (weights equal, "
          f"tsdf within {DENSE_TOL}), on all {int(away.sum())} away from a "
          f".5 rounding edge; device {in_ms:.4f} ms (CUDA graph of 20 calls),"
          f" eager {in_eager:.4f} ms, {in_launches} kernel launches per call,"
          f" peak {in_peak:.4f} GB; bytes {in_bytes}, bound "
          f"{in_bound * 1e3:.2f} us by {in_by}, at {in_bound / in_ms:.1%} of "
          f"it; {smi}", flush=True)

    # 2. raycast at strides 1, 2 and 4 from frame 30's pose; the card
    # against the CPU at stride 4
    rows = []
    for stride in (1, 2, 4):
        i_s = intr if stride == 1 else Intrinsics(
            intr.fx / stride, intr.fy / stride, intr.cx / stride,
            intr.cy / stride, intr.dist)
        h, w = H // stride, W // stride
        rc = raycast.make_raycast(dcfg, i_s, h, w)
        r = rc(got, q_d, t_d)
        torch.cuda.synchronize()
        if stride == 4:
            r_cpu = rc(ref, torch.from_numpy(q), torch.from_numpy(t))
            hit_g, hit_c = r.hit.cpu().numpy(), r_cpu.hit.numpy()
            d_g, d_c = r.depth.cpu().numpy(), r_cpu.depth.numpy()
            step = 0.75 * dcfg.truncation
            k_g = np.floor((d_g.astype(np.float64) - 0.05) / step)
            k_c = np.floor((d_c.astype(np.float64) - 0.05) / step)
            same = hit_g & hit_c & (k_g == k_c)
            dd = np.abs(d_g - d_c)[same]
            dn = np.abs(r.normal.cpu().numpy() - r_cpu.normal.numpy())[same]
            if not ((hit_g == hit_c).mean() >= DENSE_AGREE
                    and dd.max(initial=0) <= 1e-5
                    and dn.max(initial=0) <= 1e-4 and same.sum() > 1000):
                raise AssertionError(
                    f"raycast card != CPU: hit equal on "
                    f"{(hit_g == hit_c).mean()}, depth gap {dd.max()}, "
                    f"normal gap {dn.max()} on {int(same.sum())} rays")
            vs_cpu = (float((hit_g == hit_c).mean()), int(same.sum()),
                      float(dd.max()), float(dn.max()))
        n_steps = int(-(-(12.0 - 0.05) // (0.75 * dcfg.truncation))) + 1
        ms = cuda_ms(lambda: rc(got, q_d, t_d), iters=5 if stride == 1 else 20,
                     replays=4 if stride == 1 else 10)
        peak = _peak_gb(lambda: rc(got, q_d, t_d))
        launches = _launches(lambda: rc(got, q_d, t_d))
        rbytes = V * 8 + h * w * (4 + 12 + 1)   # volume read; outputs
        rb, rby = bound(rbytes, 15.0 * n_steps * h * w)
        rows.append((stride, h, w, round(ms, 4), launches, round(peak, 4),
                     round(rb * 1e3, 2), rby, f"{rb / ms:.1%}",
                     int(r.hit.sum())))
    print(f"[dense] raycast, (stride, height, width, device ms by CUDA graph, "
          f"kernel launches per call, peak GB, bound us, bound by, share of "
          f"bound, rays hit): {rows}; {n_steps} steps per ray, bound counts "
          f"the volume read once, the outputs written once and 15 flop per "
          f"sample; card vs CPU at stride 4: hit equal on {vs_cpu[0]:.6f} of "
          f"rays, on {vs_cpu[1]} rays hitting at the same step depth within "
          f"{vs_cpu[2]:.2e} m, normals within {vs_cpu[3]:.2e}; {smi}",
          flush=True)

    # 3. the shell: BA after each keyframe, fusion on keyframes
    reset_launch_counts()
    slam = track(SLAM(cfg, seq.K, device=dev), seq)
    dense_launches = check_shell_launches("dense SLAM", FRAMES)
    pts, _ = slam.dense_surface()
    T0 = seq.poses[0]
    err = np.abs((pts @ T0[:3, :3].T + T0[:3, 3])[:, 2])
    mc = slam.map_consistency()
    if not (len(pts) > 1000 and np.median(err) < 0.02 and mc is not None
            and mc["coverage"] > 0.3 and mc["median_err_m"] < dcfg.voxel_size):
        raise AssertionError(f"dense SLAM: {len(pts)} surface points, median "
                             f"|z| {np.median(err)}, consistency {mc}")
    kf_ms = [d["wall_ms"] for d in slam.diagnostics[1:] if d["added_kf"]]
    other_ms = [d["wall_ms"] for d in slam.diagnostics[1:] if not d["added_kf"]]
    pace["dense_kf_ms"] = float(np.median(kf_ms))
    t0 = time.perf_counter()
    m = slam.dense_mesh()
    mesh_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "m.ply")
        mesh.save_ply(path, m, mesh.vertex_normals(m))
        back, normals = mesh.load_ply(path)
    if not (len(m.faces) > 0 and np.array_equal(back.faces, m.faces)
            and np.allclose(back.vertices, m.vertices)
            and normals is not None):
        raise AssertionError("PLY round trip changed the mesh")
    print(f"[dense] SLAM 640x480, BA on keyframe, dense on: "
          f"{slam.num_keyframes} keyframes fused, {len(pts)} surface points, "
          f"median |z| on the plane {np.median(err) * 1e3:.2f} mm, map "
          f"consistency {mc}; median ms of keyframe frames (BA and fusion) "
          f"{np.median(kf_ms):.2f} ({len(kf_ms)}), of the others "
          f"{np.median(other_ms):.2f} ({len(other_ms)}); dense_mesh host "
          f"{mesh_ms:.1f} ms, {len(m.vertices)} vertices, {len(m.faces)} "
          f"faces, PLY round trip equal; describe launches {dense_launches};"
          f" {smi}", flush=True)

    # 4. chunked against per frame, BA off, and the stream's programs
    # replayed against the same stream with graph=False; every dispatch
    # after the capture and every fusion after the first (which captures
    # the integrate graph) under sync debug mode "error"
    per_frame = track(SLAM(cfg, seq.K, ba_mode="disabled", device=dev), seq)
    runs, progs, fusions = {}, {}, []
    for graph in (True, False):
        cs = ChunkedStream(cfg, intr, init_state(cfg, dev), chunk=CHUNK,
                           graph=graph)
        progs[graph] = watch_programs(cs)
        calls = fusions if graph else []
        cs._fuse_kf = checked_after_first(cs._fuse_kf, calls)
        got, _, _, _ = _stream(cs, seq, range(FRAMES), sync_checked=True)
        del cs._fuse_kf
        runs[graph] = (cs, got)
    same_streams(runs[True], runs[False], "chunked dense graphed vs eager")
    (cs, got_c) = runs[True]
    rows = program_rows(cs, progs[True], progs[False])
    if (len(got_c) != FRAMES or cs._depth_ring or cs.replays < 1
            or len(fusions) != per_frame.num_keyframes
            or not torch.equal(cs.tsdf.weight, per_frame.tsdf.weight)
            or float((cs.tsdf.tsdf - per_frame.tsdf.tsdf).abs().max())
            > DENSE_TOL):
        raise AssertionError(
            f"chunked dense != per frame: {len(got_c)} results, ring "
            f"{len(cs._depth_ring)}, {len(fusions)} fusions for "
            f"{per_frame.num_keyframes} keyframes")
    t_gap = float((cs.tsdf.tsdf - per_frame.tsdf.tsdf).abs().max())
    sites = sync_sites(lambda: cs._fuse_kf(got_c[0]["pose_q"],
                                           got_c[0]["pose_t"], seq.depth[0],
                                           0))

    # 5. the chunked run's volume through a checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dense.npz")
        save_checkpoint(path, cs.state, tsdf=cs.tsdf)
        back = load_checkpoint_tsdf(path, cfg, dev)
    if not (torch.equal(back.tsdf, cs.tsdf.tsdf)
            and torch.equal(back.weight, cs.tsdf.weight)):
        raise AssertionError("checkpoint changed the volume")
    print(f"[dense] ChunkedStream chunk {CHUNK}, BA off, dense on, "
          f"{cs.replays} replays: {len(fusions)} chunk-late fusions, volume "
          f"equal to per-frame SLAM (weights equal, tsdf within {t_gap:.1e}),"
          f" depth ring drained; bit-equal to the stream with graph=False "
          f"(rows, state, volume); 0 host syncs in every dispatch after the "
          f"capture and in every fusion after the first (sync debug mode "
          f"'error'; one more fusion with every sync counted: "
          f"{dict(sites)}); per program {rows}; the volume saved and loaded "
          f"bit-equal; {smi}", flush=True)
    return dense_launches


ICP_DELTA = (0.025, -0.02, 0.02, 0.012, -0.015, 0.010)  # test_dense_icp.py
ICP_POSE_M = 1e-4        # card vs CPU: tests/test_torch_icp.py's tolerances
ICP_POSE_DEG = 0.01
ICP_RMSE_M = 1e-6
ICP_VALID_SHARE = 0.005


def _icp_gap(r_dev, r_cpu, icp):
    """The card's ICP result against the CPU's: (translation m, angle deg,
    largest rmse gap m, num_valid share gap, both accepted as rescue and
    as refine); raises when a tolerance or a decision differs."""
    from kbslam_torch.slam import pose_T

    a, b = ({k: np.asarray(v.cpu()) for k, v in r._asdict().items()}
            for r in (r_dev, r_cpu))
    dT = np.linalg.inv(pose_T(b["q"], b["t"])) @ pose_T(a["q"], a["t"])
    dt = float(np.linalg.norm(dT[:3, 3]))
    dr = float(np.degrees(np.arccos(np.clip((np.trace(dT[:3, :3]) - 1) / 2,
                                            -1, 1))))
    drm = max(abs(float(a[k]) - float(b[k])) for k in ("rmse_init", "rmse"))
    dn = abs(int(a["num_valid"]) - int(b["num_valid"])) / max(
        int(b["num_valid"]), 1)

    def accepted(r, refine):
        ok = (int(r["num_valid"]) >= icp.min_points
              and float(r["rmse"]) <= icp.accept_rmse_m
              and float(r["rmse"]) <= float(r["rmse_init"]))
        return ok and (not refine or float(r["rmse"]) < float(r["rmse_init"]))

    dec = [(accepted(a, f), accepted(b, f)) for f in (False, True)]
    if not (dt <= ICP_POSE_M and dr <= ICP_POSE_DEG and drm <= ICP_RMSE_M
            and dn <= ICP_VALID_SHARE and all(x == y for x, y in dec)):
        raise AssertionError(f"ICP card != CPU: {dt} m, {dr} deg, rmse gap "
                             f"{drm}, num_valid gap {dn}, decisions {dec}, "
                             f"card {a}, CPU {b}")
    return dt, dr, drm, dn, dec[0][0]


def _blackout(height, width, cfg, mode, submap_every, dev, T=34):
    """The mask blackout of tests/test_dense_icp.py:118-163 (frames 16-21
    fully masked) at height x width on the spheres, BA on keyframe:
    the shell after it, the blackout frames, the sequence."""
    import dataclasses

    from kbslam_torch.io import synthetic
    from kbslam_torch.slam import SLAM

    seq = synthetic.render_sequence(num_frames=T, height=height, width=width,
                                    scene="spheres")
    mask = seq.mask.copy()
    black = list(range(16, 22))
    mask[black] = 0
    cfg = cfg.replace(dense=dataclasses.replace(
        cfg.dense, enabled=True, submap_every=submap_every),
        dense_icp=dataclasses.replace(cfg.dense_icp, mode=mode))
    slam = SLAM(cfg, seq.K, ba_mode="on_keyframe", use_mask=True, device=dev)
    for i in range(T):
        slam.process(seq.rgb[i], seq.depth[i], mask[i])
    return slam, black, seq


def _rescue_gates(slam, black, seq, gate_m, what):
    """tests/test_dense_icp.py's rescue gates; returns (accepted rescues,
    median ms of rescue frames, of tracked frames, worst error m)."""
    rescued = [e["frame"] for e in slam.icp_events
               if e["mode"] == "rescue" and e["accepted"]]
    n_ok = sum(slam.diagnostics[i]["success"] for i in black)
    T0 = seq.poses[0]
    errs = [float(np.linalg.norm((T0 @ slam.frame_poses[i])[:3, 3]
                                 - seq.poses[i][:3, 3]))
            for i in black if slam.diagnostics[i]["success"]]
    if not (len(rescued) >= 4 and n_ok >= 4 and max(errs) < gate_m
            and slam.diagnostics[-1]["success"]):
        raise AssertionError(f"{what}: rescues {rescued}, {n_ok} blackout "
                             f"successes, errors {errs} (gate {gate_m} m), "
                             f"last frame {slam.diagnostics[-1]}")
    d = slam.diagnostics
    tracked = [x["wall_ms"] for x in d[1:] if x["frame"] not in black
               and x["success"] and not x["added_kf"]]
    return (len(rescued), float(np.median([d[i]["wall_ms"] for i in rescued])),
            float(np.median(tracked)), max(errs))


def submap_phase(dev, seq, smi, pace) -> int:
    """(17) The submap atlas and dense ICP at SLAMConfig()'s
    DenseMapConfig (96x96x32 voxels) with 16 submaps and 640x480:
    start_submap and integrate_active on the card against the CPU; the
    two aligners on the card against the CPU, timed beside their bounds,
    and the atlas aligner on the dense cell's 512^3 ring against its plain
    twin; SLAM with the atlas and BA on keyframe; ChunkedStream (chunk 8, BA
    off) with the atlas against per-frame SLAM; the atlas through a
    checkpoint; the dense ICP rescue through a mask blackout at 320x240
    and at 640x480, and one refine pass. Returns the describe launches of
    the atlas SLAM run."""
    import dataclasses
    import tempfile

    from kbslam_torch import config, convert
    from kbslam_torch.config import DenseIcpConfig
    from kbslam_torch.geom.camera import Intrinsics
    from kbslam_torch.geom.se3 import SE3, quat_rotate
    from kbslam_torch.io.checkpoint import (load_checkpoint_atlas,
                                            save_checkpoint)
    from kbslam_torch.mapping import dense, icp, submap
    from kbslam_torch.ops import icp as icp_ops
    from kbslam_torch.pipeline import init_state
    from kbslam_torch.slam import SLAM
    from kbslam_torch.streaming import ChunkedStream

    base = config.SLAMConfig()
    cfg = base.replace(dense=dataclasses.replace(
        base.dense, enabled=True, submap_every=2))
    dcfg, scale = cfg.dense, cfg.map.depth_scale
    S = dcfg.max_submaps
    intr = Intrinsics.from_matrix(seq.K)
    H, W = seq.depth.shape[1:]
    V = int(np.prod(dcfg.dims))
    cpu = torch.device("cpu")
    P0 = np.linalg.inv(seq.poses[0])     # the SLAM gauge: camera 0
    poses = {i: P0 @ seq.poses[i] for i in range(FRAMES)}

    def qt(T, device):
        return [torch.from_numpy(a).to(device) for a in _pose_qt(T)]

    def depth(i, device):
        return torch.from_numpy(seq.depth[i].astype(np.int32)).to(device)

    # 1. the atlas module: submaps anchored at frames 0, 20 and 40, each
    # fusing its anchor frame and the fifth after it on the CPU; then
    # frame 50 into the third on the card and on the CPU
    start, fuse = submap.make_submap_ops(dcfg, intr, S, scale)
    atlas = submap.empty_atlas(dcfg, S, cpu)
    for a in (0, 20, 40):
        atlas = start(atlas, *qt(poses[a], cpu), a // 2)
        for i in (a, a + 5):
            atlas = fuse(atlas, depth(i, cpu), *qt(poses[i], cpu),
                         *qt(poses[a], cpu))

    def on(device):
        return convert.atlas_to_torch(convert.atlas_to_numpy(atlas), device)

    atlas_d, atlas_t = on(dev), on(dev)      # atlas_t: for the timing
    args_d = (depth(50, dev), *qt(poses[50], dev), *qt(poses[40], dev))
    got = fuse(on(dev), *args_d)
    ref = fuse(on(cpu), depth(50, cpu), *qt(poses[50], cpu),
               *qt(poses[40], cpu))
    torch.cuda.synchronize()
    s = got.active_slot()
    w_eq = (got.weight[s].cpu() == ref.weight[s]).numpy().reshape(-1)
    t_ok = ((got.tsdf[s].cpu() - ref.tsdf[s]).abs()
            <= DENSE_TOL).numpy().reshape(-1)
    agree = w_eq & t_ok
    away = ~_near_round_edge(dcfg, intr, *_pose_qt(np.linalg.inv(poses[40])
                                                   @ poses[50]))
    others = [k for k in range(S) if k != s]
    same_rest = (all(torch.equal(x.cpu(), y) for x, y in zip(got[2:5],
                                                             ref[2:5]))
                 and all(torch.equal(x[others].cpu(), y[others])
                         for x, y in zip(got[:2], ref[:2])))
    if not (agree[away].all() and agree.mean() >= DENSE_AGREE and same_rest
            and got.count == ref.count == 3):
        raise AssertionError(
            f"integrate_active card != CPU: {int((~agree).sum())} voxels of "
            f"{V} disagree, {int((~agree & away).sum())} away from an edge, "
            f"other slots and anchors equal: {same_rest}")
    st_d = start(submap.empty_atlas(dcfg, S, dev), *qt(poses[0], dev), 0)
    st_c = start(submap.empty_atlas(dcfg, S, cpu), *qt(poses[0], cpu), 0)
    if not all(torch.equal(x.cpu(), y) for x, y in zip(st_d[:5], st_c[:5])):
        raise AssertionError("start_submap card != CPU")
    in_ms = cuda_ms(lambda: fuse(atlas_t, *args_d))
    in_launches = _launches(lambda: fuse(atlas_t, *args_d))
    in_peak = _peak_gb(lambda: fuse(atlas_t, *args_d))
    st_ms = cuda_ms(lambda: start(atlas_t, *args_d[1:3], 0))
    in_bytes = 4 * V * 4 + H * W * 4    # the slot read and written; depth
    in_bound, in_by = bound(in_bytes, 50.0 * V)
    pace["integrate_active"] = (in_ms, in_launches, in_peak, in_bound, in_by)
    print(f"[submaps] atlas of {S} x {dcfg.dims} ({2 * S * V * 4 / 1e6:.1f} "
          f"MB): start_submap card equal to the CPU; integrate_active of a "
          f"640x480 frame into submap 3 equal on {agree.mean():.6f} of the "
          f"slot's voxels (weights equal, tsdf within {DENSE_TOL}), on all "
          f"{int(away.sum())} away from a .5 rounding edge, other slots and "
          f"anchors bit-equal; integrate_active device {in_ms:.4f} ms (CUDA "
          f"graph of 20 calls), {in_launches} launches per call, peak "
          f"{in_peak:.4f} GB, bound {in_bound * 1e3:.2f} us by {in_by} "
          f"({in_bytes} bytes), at {in_bound / in_ms:.1%} of it; "
          f"start_submap {st_ms:.4f} ms; {smi}", flush=True)

    # 2. the aligners on frame 25 from a perturbed pose, 8 trips at
    # stride 4, against a volume of frames 0-50 (every tenth) and the
    # three submaps above
    icfg = DenseIcpConfig(stride=4, iters=8, atlas_slots=3)
    vol = dense.empty_tsdf(dcfg, cpu)
    integ = dense.make_integrate(dcfg, intr, scale)
    for i in range(0, FRAMES, 10):
        vol = integ(vol, depth(i, cpu), *qt(poses[i], cpu))
    delta = SE3.exp(torch.tensor(ICP_DELTA, dtype=torch.float64)).matrix()
    q0c, t0c = qt(delta.numpy() @ poses[25], cpu)
    q0d, t0d = q0c.to(dev), t0c.to(dev)
    vol_d = convert.tsdf_to_torch(convert.tsdf_to_numpy(vol), dev)
    mono = icp.make_icp(dcfg, icfg, intr, scale)
    win = submap.recent_slots_with_poses(
        atlas, init_state(base, cpu).map, 3)         # no ring: stored poses
    win_c = [torch.from_numpy(a) for a in win]
    win_d = [a.to(dev) for a in win_c]
    many = icp.make_icp_atlas(dcfg, icfg, intr, scale)
    P = (H // 4) * (W // 4)
    d_c, d_d = depth(25, cpu), depth(25, dev)
    atlas_c = on(cpu)
    p_cam, p_ok = icp._frame_points(d_d.to(torch.float32) * scale, intr,
                                    dcfg, icfg.stride)
    slot0 = torch.zeros(1, dtype=torch.int32, device=dev)
    rows = []
    for name, fn_d, fn_c, twin_args, K in (
            ("align_depth_to_tsdf", lambda: mono(vol_d, d_d, q0d, t0d),
             lambda: mono(vol, d_c, q0c, t0c),
             (vol_d.tsdf[None], vol_d.weight[None], slot0, None, None), 1),
            ("align_depth_to_atlas",
             lambda: many(atlas_d, *win_d, d_d, q0d, t0d),
             lambda: many(atlas_c, *win_c, d_c, q0c, t0c),
             (atlas_d.tsdf, atlas_d.weight, *win_d), 3)):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            r_d = fn_d()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        gap = _icp_gap(r_d, fn_c(), icfg)

        def twin(a=twin_args):      # the kernels' plain twin, on the card
            return icp_ops.align_reference(*a, p_cam, p_ok, q0d, t0d, dcfg,
                                           icfg)

        if not all(torch.equal(a, b) for a, b in zip(r_d, twin())):
            raise AssertionError(f"{name}: the kernel's solve != the plain "
                                 f"twin's on the card")
        ms = cuda_ms(fn_d)
        twin_ms = cuda_ms(twin)
        launches = _launches(fn_d)
        kernels = _launches(fn_d, "icp_fetch_kernel")
        k_ms, k_replay = _graph_kernels(fn_d, "icp_fetch_kernel")
        if not kernels == k_replay == icfg.iters + 1:
            raise AssertionError(f"{name}: {kernels} fetch kernels in an "
                                 f"eager solve, {k_replay} in a replay, not "
                                 f"{icfg.iters} + 1")
        peak = _peak_gb(fn_d)
        # bytes (slambench/harness/dense_bytes.icp_bytes): the depth image
        # once, and per fetch the 8 corners' tsdf and weight of each point
        # in each slot; operations: per point, slot and fetch ~150 flop
        # (transform, trilinear value and gradient), and per point and
        # trip ~100 (Jacobian, normal equations)
        nbytes = H * W * 4 + (icfg.iters + 1) * 8 * 2 * 4 * P * K
        flops = P * ((icfg.iters + 1) * 150.0 * K + icfg.iters * 100.0)
        b, by = bound(nbytes, flops)
        rows.append((name, K, round(ms, 4), round(twin_ms, 4), launches,
                     kernels, round(peak, 4), round(b * 1e3, 2), by,
                     f"{b / ms:.2%}", int(r_d.num_valid),
                     round(float(r_d.rmse_init), 5), round(float(r_d.rmse), 5),
                     gap[4], f"{gap[0]:.1e} m", f"{gap[1]:.1e} deg",
                     round(k_ms, 4)))
    pace["icp_rows"] = rows
    print(f"[submaps] aligners on one 640x480 frame ({P} points, stride 4, "
          f"{icfg.iters} trips, perturbed by tests/test_dense_icp.py's "
          f"delta), 0 host syncs inside a solve (sync debug mode 'error'), "
          f"card against the CPU within {ICP_POSE_M} m, {ICP_POSE_DEG} deg, "
          f"rmse {ICP_RMSE_M} m, num_valid {ICP_VALID_SHARE:.1%}, decisions "
          f"equal, bit-equal to the plain twin on the card; (name, slots, "
          f"device ms by CUDA graph of 20 calls, the plain twin's ms on the "
          f"card, launches per call, of them the fetch kernel of "
          f"csrc/icp.cu, peak GB, bound us, bound by, share of bound, "
          f"num_valid, rmse_init, rmse, accepted, pose gap card-CPU, the "
          f"fetch kernels' own device ms in a profiled replay of a solve): "
          f"{rows}; {smi}", flush=True)

    # 2b. the atlas aligner at the dense benchmark cell's grid and ring
    # (slambench/configs/tum-fr1-desk-dense512.json: 16 slots of 512^3
    # voxels of 3/512 m, 17.2 GB): submaps anchored at frames 15, 30 and
    # 45 in the ring's last three slots (slot 15 starts 15 * 2^27 voxels
    # in), each fusing its anchor frame and the fifth after it on the
    # card; frame 25 from the perturbed pose against the window
    # [15, 14, 13] and the stored anchors, bit-equal to the plain twin on
    # the card, 8 + 1 fetch launches a solve, timed as above
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "slambench", "configs", "tum-fr1-desk-dense512.json")
    with open(path) as f:
        cell = json.load(f)["slam"]["dense"]
    big = dataclasses.replace(
        dcfg, dims=tuple(cell["dims"]), voxel_size=cell["voxel_size"],
        origin=tuple(cell["origin"]), truncation=cell["truncation"])
    S_big = cell["max_submaps"]
    bstart, bfuse = submap.make_submap_ops(big, intr, S_big, scale)
    ring = submap.empty_atlas(big, S_big, dev)
    bslots = list(range(S_big - 1, S_big - 4, -1))        # newest first
    for a, sl in zip((15, 30, 45), reversed(bslots)):
        ring = bstart(ring, *qt(poses[a], dev), a // 2, slot=sl)
        for i in (a, a + 5):
            ring = bfuse(ring, depth(i, dev), *qt(poses[i], dev),
                         *qt(poses[a], dev), slot=sl)
    bwin = torch.tensor(bslots, dtype=torch.int32, device=dev)
    bwin_q, bwin_t = ring.anchor_q[bwin].contiguous(), ring.anchor_t[
        bwin].contiguous()
    bmany = icp.make_icp_atlas(big, icfg, intr, scale)
    bp_cam, bp_ok = icp._frame_points(d_d.to(torch.float32) * scale, intr,
                                      big, icfg.stride)

    def big_solve():
        return bmany(ring, bwin, bwin_q, bwin_t, d_d, q0d, t0d)

    def big_twin():
        return icp_ops.align_reference(ring.tsdf, ring.weight, bwin, bwin_q,
                                       bwin_t, bp_cam, bp_ok, q0d, t0d, big,
                                       icfg)

    got_b, want_b = big_solve(), big_twin()
    # the window's first valid slot of each point at the start pose
    valids = icp_ops.fetch_slots(ring.tsdf, ring.weight, bwin, bwin_q,
                                 bwin_t, big,
                                 quat_rotate(q0d, bp_cam) + t0d)[2] & bp_ok
    per_slot = [int(x) for x in torch.bincount(
        torch.argmax(valids.to(torch.uint8), dim=0)[valids.any(dim=0)],
        minlength=3)]
    if not (all(torch.equal(a, b) for a, b in zip(got_b, want_b))
            and int(got_b.num_valid) > 1000):
        raise AssertionError(f"512^3 ring: the kernel's solve {got_b} != "
                             f"the plain twin's {want_b} on the card, or "
                             f"too few valid points")
    b_kernels = _launches(big_solve, "icp_fetch_kernel")
    bk_ms, bk_replay = _graph_kernels(big_solve, "icp_fetch_kernel")
    if not b_kernels == bk_replay == icfg.iters + 1:
        raise AssertionError(f"512^3 ring: {b_kernels} fetch kernels in an "
                             f"eager solve, {bk_replay} in a replay, not "
                             f"{icfg.iters} + 1")
    b_ms, b_twin_ms = cuda_ms(big_solve), cuda_ms(big_twin)
    pace["icp_big"] = (b_ms, b_twin_ms, bk_ms, b_kernels)
    print(f"[submaps] the atlas aligner on the dense cell's ring ({S_big} x "
          f"{big.dims} voxels of {big.voxel_size} m, window {bslots}): "
          f"bit-equal to the plain twin on the card, num_valid "
          f"{int(got_b.num_valid)}, rmse_init {float(got_b.rmse_init):.6f}"
          f" m, rmse {float(got_b.rmse):.6f} m, points whose first valid "
          f"slot at the start pose is the window's 1st, 2nd, 3rd "
          f"{per_slot}; {b_kernels} fetch kernels a solve; device ms by CUDA"
          f" graph of 20 calls {b_ms:.4f}, of it the fetch kernels "
          f"{bk_ms:.4f} (profiled replay), the plain twin's {b_twin_ms:.4f};"
          f" {smi}", flush=True)
    del ring, bwin, bwin_q, bwin_t, got_b, want_b, valids
    torch.cuda.empty_cache()

    # 3. SLAM with the atlas and BA on keyframe (the main path of this
    # phase: the describe kernel once per frame)
    reset_launch_counts()
    slam = track(SLAM(cfg, seq.K, device=dev), seq)
    sub_launches = check_shell_launches("atlas SLAM", FRAMES)
    n_ins = sum(d["added_kf"] for d in slam.diagnostics)
    pts, _ = slam.dense_surface()
    T0 = seq.poses[0]
    err = np.abs((pts @ T0[:3, :3].T + T0[:3, 3])[:, 2])
    mc = slam.map_consistency()
    m = slam.dense_mesh()
    if not (slam.atlas.count == (n_ins + 1) // 2
            and len(pts) > 1000 and np.median(err) < 0.02 and mc is not None
            and mc["coverage"] > 0.3 and mc["median_err_m"] < dcfg.voxel_size
            and len(m.faces) > 0):
        raise AssertionError(
            f"atlas SLAM: describe launches {sub_launches}, {slam.atlas.count}"
            f" submaps for {n_ins} insertions, {len(pts)} surface points, "
            f"median |z| {np.median(err)}, consistency {mc}, {len(m.faces)} "
            f"faces")
    kf_ms = [d["wall_ms"] for d in slam.diagnostics[1:] if d["added_kf"]]
    print(f"[submaps] SLAM 640x480, BA on keyframe, submap every 2: "
          f"{n_ins} insertions, {slam.atlas.count} submaps, anchors "
          f"{slam.atlas.anchor_kf_id.tolist()}, {len(pts)} surface points, "
          f"median |z| on the plane {np.median(err) * 1e3:.2f} mm, map "
          f"consistency {mc}, mesh {len(m.vertices)} vertices; median ms of "
          f"keyframe frames (BA and fusion) {np.median(kf_ms):.2f} "
          f"({len(kf_ms)}), phase 16's (monolithic) "
          f"{pace['dense_kf_ms']:.2f}; describe launches {sub_launches}; "
          f"{smi}", flush=True)

    # 4. chunked against per frame, BA off, and the stream's programs
    # replayed against the same stream with graph=False; every fusion of
    # each shell counted for host syncs (none but a capture's entry), and
    # every dispatch after the capture under sync debug mode "error"
    def checked_shell(fn, calls):
        # a fusion that captures a graph (the first start and the first
        # fuse) may sync in torch's capture entry; nothing else may
        from kbslam_torch import device
        from kbslam_torch.utils.profiling import sync_sites

        def run(*args):
            before = sum(device.captures.values())
            sites = sync_sites(lambda: fn(*args))
            if sum(device.captures.values()) > before:
                sites = {k: n for k, n in sites.items()
                         if "torch/cuda/graphs.py" not in k}
            if sum(sites.values()):
                raise AssertionError(f"host syncs in a fusion: {sites}")
            calls.append(1)
        return run

    per_frame = SLAM(cfg, seq.K, ba_mode="disabled", device=dev)
    pf_fusions = []
    per_frame._fuse = checked_shell(per_frame._fuse, pf_fusions)
    track(per_frame, seq)
    del per_frame._fuse
    runs, progs, fusions = {}, {}, []
    for graph in (True, False):
        cs = ChunkedStream(cfg, intr, init_state(cfg, dev), chunk=CHUNK,
                           graph=graph)
        progs[graph] = watch_programs(cs)
        cs._fuse_kf = checked_shell(cs._fuse_kf, fusions if graph else [])
        got, _, _, _ = _stream(cs, seq, range(FRAMES), sync_checked=True)
        del cs._fuse_kf
        runs[graph] = (cs, got)
    same_streams(runs[True], runs[False], "chunked atlas graphed vs eager")
    (cs, got_c) = runs[True]
    rows = program_rows(cs, progs[True], progs[False])
    eq = [torch.equal(a, b) for a, b in zip(cs.atlas[:5], per_frame.atlas[:5])]
    if not (len(got_c) == FRAMES and not cs._depth_ring and cs.replays >= 1
            and len(fusions) == len(pf_fusions) == per_frame.num_keyframes
            and cs.atlas.count == per_frame.atlas.count >= 2 and all(eq)):
        raise AssertionError(
            f"chunked atlas != per frame: {len(got_c)} results, ring "
            f"{len(cs._depth_ring)}, fusions {len(fusions)} / "
            f"{len(pf_fusions)}, counts {cs.atlas.count} / "
            f"{per_frame.atlas.count}, fields equal {eq}")

    # 5. the chunked run's atlas through a checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "atlas.npz")
        save_checkpoint(path, cs.state, atlas=cs.atlas,
                        kf_insertions=cs._kf_insertions)
        back, kf_ins = load_checkpoint_atlas(path, cfg, dev)
    if not (kf_ins == cs._kf_insertions and back.count == cs.atlas.count
            and all(torch.equal(a, b) for a, b in zip(back[:5],
                                                      cs.atlas[:5]))):
        raise AssertionError("checkpoint changed the atlas")
    print(f"[submaps] ChunkedStream chunk {CHUNK}, BA off, submaps on, "
          f"{cs.replays} replays: {len(fusions)} chunk-late fusions into "
          f"{cs.atlas.count} submaps, atlas (tsdf, weight, anchors, ids) "
          f"bit-equal to per-frame SLAM's, depth ring drained; bit-equal to "
          f"the stream with graph=False (rows, state, atlas); 0 host syncs "
          f"in every dispatch after the capture and in every fusion of each "
          f"shell but a capture's entry; per program {rows}; the atlas saved "
          f"and loaded bit-equal; {smi}", flush=True)

    # 6. dense ICP rescue through the mask blackout: at the test's own
    # 320x240 configuration, then at 640x480 with SLAMConfig()'s ORB and
    # map; and one refine pass over the 60-frame plane
    small = config.SLAMConfig(
        image_height=240, image_width=320,
        orb=config.OrbConfig(num_features=512, num_levels=4,
                             max_features=512),
        pnp=config.PnPConfig(num_hypotheses=128),
        map=config.MapConfig(max_keyframes=16, max_map_points=8192))
    off, black, bseq = _blackout(240, 320, small, "off", 0, dev)
    if any(off.diagnostics[i]["success"] for i in black):
        raise AssertionError("blackout frames track without ICP")
    rescue = []
    for (h, w, c) in ((240, 320, small), (480, 640, base)):
        for every, gate in ((0, 0.08), (1, 0.12)):
            sl, black, bseq = _blackout(h, w, c, "rescue", every, dev)
            rescue.append((f"{w}x{h}", "atlas" if every else "volume") +
                          tuple(round(x, 4) for x in _rescue_gates(
                              sl, black, bseq, gate, f"rescue {w}x{h}")))
    rcfg = cfg.replace(dense=dataclasses.replace(cfg.dense, submap_every=0),
                       dense_icp=dataclasses.replace(cfg.dense_icp,
                                                     mode="refine"))
    # the main path's fetch kernels: each capture's warm-up solves
    # eagerly (counted by ops.icp.launches), each replay runs iters + 1
    from kbslam_torch import device as device_mod

    reset_launch_counts()
    icp_ops.reset_launches()
    ref_slam = track(SLAM(rcfg, seq.K, device=dev), seq)
    trips = rcfg.dense_icp.iters + 1
    solves = device_mod.replays["icp"]
    warm = device_mod.captures["icp"]
    if not (solves == len(ref_slam.icp_events)
            and icp_ops.launches == warm * trips):
        raise AssertionError(
            f"refine: {solves} icp replays for {len(ref_slam.icp_events)} "
            f"solves, {icp_ops.launches} eager fetch launches for {warm} "
            f"captures")
    main_fetches = (warm + solves) * trips
    pace["icp_main"] = (main_fetches, solves, warm)
    refines = [e for e in ref_slam.icp_events if e["mode"] == "refine"]
    plain = [d["wall_ms"] for d in ref_slam.diagnostics[1:]
             if not d["ran_ba"]]
    if not refines or any(e["accepted"] and not e["rmse"] < e["rmse_init"]
                          for e in refines):
        raise AssertionError(f"refine: {refines}")
    print(f"[submaps] dense ICP rescue through the mask blackout (frames "
          f"16-21 of 34 spheres, BA on keyframe), held to tests/"
          f"test_dense_icp.py's gates (8 cm, 12 cm with the atlas); no "
          f"blackout frame tracks without ICP at 320x240; (size, model, "
          f"accepted rescues, median ms of rescue frames, of tracked frames, "
          f"worst error m): {rescue}; refine over the 60-frame plane with "
          f"BA on keyframe: {len(refines)} refines, "
          f"{sum(e['accepted'] for e in refines)} accepted, median "
          f"{np.median(plain):.2f} ms of frames without a solve against "
          f"phase 7's {pace['slam_ba_ms']:.2f}; fetch kernels run "
          f"{main_fetches}: ({warm} capture warm-ups + {solves} replays of "
          f"the icp graph) x {trips}; {smi}", flush=True)
    return sub_launches


# --- 18-20: global BA, multistream, the long run --------------------------

GBA_CAMS, GBA_PTS, GBA_OBS = 200, 50_000, 512   # BASELINE.json config 5
GBA_ROUNDS, GBA_PCG, GBA_TOL, GBA_RETRIES = 4, 25, 1e-2, 4
MS_STREAMS, MS_FRAMES, MS_K = 8, 33, 4          # BASELINE.json config 4


def global_ba_problem(seed=0, noise=0.01):
    """Config 5 on the host, built as benchmarks/global_ba_stress.py:40-99
    builds it: 50,000 landmarks along a 100 m corridor; 200 cameras sweep
    past it, each observing 512 of the 4,000 landmarks nearest to it (a
    sliding window of co-visibility), 102,400 observations; the initial
    poses (but camera 0's, the gauge) and landmarks (but landmark 0, the
    scale anchor) off by ``noise``. Returns (data on the CPU, intrinsics,
    true landmarks)."""
    from scipy.spatial.transform import Rotation

    from kbslam_torch.ba.global_ba import GlobalBAData
    from kbslam_torch.geom.camera import Intrinsics
    from kbslam_torch.geom.se3 import matrix_to_quat

    rng = np.random.default_rng(seed)
    n_cams, n_pts, per_cam = GBA_CAMS, GBA_PTS, GBA_OBS
    fx = fy = 500.0
    cx = cy = 320.0
    pts = np.stack([np.linspace(0, 100, n_pts) + rng.normal(0, 0.1, n_pts),
                    rng.uniform(-3, 3, n_pts), rng.uniform(4, 8, n_pts)],
                   axis=1).astype(np.float32)
    rots, ts, uvs, ids, active = [], [], [], [], []
    for i in range(n_cams):
        t = np.array([100.0 * i / n_cams, 0.0, 0.0], np.float32)
        R = Rotation.from_rotvec([0, 0.002 * i, 0]).as_matrix().astype(
            np.float32)
        center = int(n_pts * i / n_cams)
        cand = rng.choice(np.arange(max(0, center - 2000),
                                    min(n_pts, center + 2000)),
                          size=per_cam, replace=False)
        pc = (pts[cand] - t) @ R
        uvs.append(np.stack([fx * pc[:, 0] / pc[:, 2] + cx,
                             fy * pc[:, 1] / pc[:, 2] + cy], -1))
        active.append(pc[:, 2] > 0.5)
        if i > 0:
            dR = Rotation.from_rotvec(rng.normal(scale=noise,
                                                 size=3)).as_matrix()
            R = (R @ dR).astype(np.float32)
            t = t + rng.normal(scale=noise, size=3).astype(np.float32)
        rots.append(R)
        ts.append(t)
        ids.append(cand.astype(np.int32))
    mp_pos = pts + rng.normal(scale=noise, size=pts.shape).astype(np.float32)
    mp_pos[0] = pts[0]
    cam_free = np.ones(n_cams, bool)
    cam_free[0] = False
    zeros = torch.zeros((n_cams, per_cam))

    def t_(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(np.stack(a), dtype))

    data = GlobalBAData(
        cam_q=matrix_to_quat(t_(rots)), cam_t=t_(ts),
        obs_uv=t_(uvs, np.float32), mp_id=t_(ids), active=t_(active),
        w_z=zeros + 1.0, z_meas=zeros.clone(), w_d=zeros.clone(),
        cam_free=torch.from_numpy(cam_free), mp_pos=torch.from_numpy(mp_pos),
        anchor_mp=torch.zeros((), dtype=torch.int32))
    return data, Intrinsics.create(fx, fy, cx, cy), pts


def global_ba_phase(dev, smi, slam7, seq, ate7):
    """(18) Config 5: one guarded solve (4 rounds, PCG cap 25, tol 1e-2)
    on the card against the port's CPU path, sync-checked, then captured
    and replayed; then ``SLAM.run_global_ba`` on phase 7's map.

    The problem leaves many landmarks seen by one or two cameras, whose
    3x3 blocks are near singular (held by the 1e-8 floor), so float32
    rounding moves the iterates from the first round on: the CPU against
    itself with the landmarks moved by 1e-7 m drifts ~2e-4, 1e-3, 1e-2
    and 6e-2 in the cost of rounds 1-4. So the card is held to the CPU by
    equal ``accepted`` and ``retries``, PCG trips within +-1 per round
    and the first round's cost within 1e-3; every round's gap is printed
    beside the CPU's own, and both runs must descend monotonically to
    below 1e-2 of the start. Returns what phase 22 holds its sharded
    runs to: the eager solve's results and phase 7's map before and after
    ``run_global_ba``, on the host."""
    from kbslam_torch import convert
    from kbslam_torch.ba import global_ba as gba
    from kbslam_torch.device import CapturedCall
    from kbslam_torch.eval import trajectory
    from kbslam_torch.mapping.state import window_slots

    t0 = time.perf_counter()
    data_cpu, intr, pts = global_ba_problem()
    build_s = time.perf_counter() - t0
    data = gba.GlobalBAData(*(x.to(dev) for x in data_cpu))
    n_obs = int(data_cpu.active.sum())

    def solve(d):
        return gba.global_ba_solve(d, intr, iters=GBA_ROUNDS,
                                   pcg_iters=GBA_PCG, pcg_tol=GBA_TOL,
                                   max_retries=GBA_RETRIES, return_stats=True)

    solve(data)             # warm-up: library handles, the allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        out, costs, stats = solve(data)
        host_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    end_ms = (time.perf_counter() - t0) * 1e3
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9

    t0 = time.perf_counter()
    ref, ref_costs, ref_stats = solve(data_cpu)
    cpu_s = time.perf_counter() - t0
    # the CPU against itself, the landmarks moved by 1e-7 m: how far
    # float32 rounding alone moves each round (see the docstring)
    g = torch.Generator().manual_seed(0)
    nudged = solve(data_cpu._replace(mp_pos=data_cpu.mp_pos + 1e-7 * torch.randn(
        data_cpu.mp_pos.shape, generator=g)))[1].numpy()
    c, rc = costs.cpu().numpy(), ref_costs.numpy()
    pcg, rpcg = stats.pcg_iters.cpu().numpy(), ref_stats.pcg_iters.numpy()
    rel = np.abs(c - rc) / np.abs(rc)
    rel_cpu = np.abs(nudged - rc) / np.abs(rc)
    if not (torch.equal(stats.accepted.cpu(), ref_stats.accepted)
            and torch.equal(stats.retries.cpu(), ref_stats.retries)
            and (np.abs(pcg - rpcg) <= 1).all() and rel[1] <= 1e-3):
        raise AssertionError(
            f"global BA card != CPU: costs {c} vs {rc}, accepted "
            f"{stats.accepted.tolist()} vs {ref_stats.accepted.tolist()}, "
            f"retries {stats.retries.tolist()} vs {ref_stats.retries.tolist()}"
            f", PCG {pcg} vs {rpcg}")
    for what, x in (("card", c), ("CPU", rc)):
        if not (np.isfinite(x).all() and (np.diff(x) <= 0).all()
                and x[-1] < 1e-2 * x[0]):
            raise AssertionError(f"global BA costs on the {what}: {x}")

    graphed = CapturedCall(solve, data)
    got = graphed(data)
    torch.cuda.synchronize()
    mine = list(out) + [costs] + list(stats)
    theirs = list(got[0]) + [got[1]] + list(got[2])
    if not all(torch.equal(a, b) for a, b in zip(mine, theirs)):
        raise AssertionError("the replayed global BA != the eager solve")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reps = []
    for _ in range(3):
        start.record()
        graphed.graph.replay()
        end.record()
        torch.cuda.synchronize()
        reps.append(start.elapsed_time(end))
    graph_ms = float(np.median(reps))
    g_launch, nodes, kern_ms, _, _, top = _replay_profile(graphed.graph)
    err = np.linalg.norm(out.mp_pos.cpu().numpy() - pts, axis=1)
    live = int(pcg.sum())
    total = GBA_ROUNDS * GBA_RETRIES * GBA_PCG
    print(f"[global_ba] config 5: {GBA_CAMS} cameras, {GBA_PTS} landmarks, "
          f"{GBA_CAMS * GBA_OBS} observations ({n_obs} in front), built in "
          f"{build_s:.2f} s; {GBA_ROUNDS} LM rounds, PCG cap {GBA_PCG}, tol "
          f"{GBA_TOL}: cost {[round(float(x), 3) for x in c]} (CPU "
          f"{[round(float(x), 3) for x in rc]}; relative gap per round "
          f"{[float(f'{x:.2e}') for x in rel[1:]]}, the CPU against itself "
          f"with the landmarks moved by 1e-7 m "
          f"{[float(f'{x:.2e}') for x in rel_cpu[1:]]}), accepted "
          f"{stats.accepted.tolist()}, retries "
          f"{stats.retries.tolist()} (equal on the CPU), PCG trips per round "
          f"{pcg.tolist()} (CPU {rpcg.tolist()}); live PCG trips {live}, "
          f"masked {total - live} of {total}; landmark error median "
          f"{np.median(err) * 1e3:.3f} mm (start "
          f"{np.median(np.linalg.norm(data_cpu.mp_pos.numpy() - pts, axis=1)) * 1e3:.3f}"
          f" mm); 0 host syncs in the solve (sync debug mode 'error'); "
          f"device {graph_ms:.2f} ms per solve (replays of the captured "
          f"solve, CUDA events; {[round(r, 2) for r in reps]}), the replay "
          f"bit-equal to the eager solve; {nodes} kernel launches and "
          f"{kern_ms:.2f} ms kernel time per solve (torch.profiler, "
          f"{g_launch} graph launch); host {host_ms:.1f} ms to enqueue "
          f"the eager solve, {end_ms:.1f} ms to its end; peak device "
          f"memory {peak_gb:.3f} GB; CPU solve {cpu_s:.1f} s; kernels with "
          f"the most device time {top}; {smi}", flush=True)

    # SLAM.run_global_ba on phase 7's map: the oldest real keyframe is
    # the gauge. From the same map four times: eagerly
    # (run_global_ba_on_map(graph=False), the yardstick), then the
    # shell's call three times (eager, the shape's first solve; the
    # capture and a replay; a replay)
    from kbslam_torch import device
    from kbslam_torch.pipeline import clone_state
    from kbslam_torch.slam import run_global_ba_on_map

    m = slam7.state.map
    n_cams = min(int(m.num_kf), m.capacity_kf)
    slots, _, real = window_slots(m, n_cams)
    g = int(slots[int(torch.argmax(real.to(torch.int32)))])
    gauge = (m.kf_q[g].clone(), m.kf_t[g].clone())
    map_before = convert.map_to_numpy(m)
    saved = clone_state(slam7.state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager_map, eager_costs = run_global_ba_on_map(
        saved.map, slam7.intr, slam7.config.ba, graph=False)
    eager_ms = (time.perf_counter() - t0) * 1e3
    calls = []
    for k in range(3):
        slam7.state = saved
        captured = device.captures["global_ba"]
        replayed = device.replays["global_ba"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_costs = slam7.run_global_ba()
        ms = (time.perf_counter() - t0) * 1e3
        m = slam7.state.map
        if not (run_costs == eager_costs and all(
                torch.equal(getattr(m, f), getattr(eager_map, f))
                for f in ("kf_q", "kf_t", "mp_pos"))):
            raise AssertionError(f"SLAM.run_global_ba, call {k + 1}, != the "
                                 "eager solve")
        calls.append((round(ms, 1), device.captures["global_ba"] - captured,
                      device.replays["global_ba"] - replayed))
    if [c[1:] for c in calls] != [(0, 0), (1, 1), (0, 1)]:
        raise AssertionError(f"run_global_ba (ms, captures, replays) per "
                             f"call: {calls}")
    rc = np.asarray(run_costs)
    if not (np.isfinite(rc).all() and (np.diff(rc) <= 0).all()):
        raise AssertionError(f"SLAM.run_global_ba costs {run_costs}")
    if not (torch.equal(m.kf_q[g], gauge[0])
            and torch.equal(m.kf_t[g], gauge[1])):
        raise AssertionError("SLAM.run_global_ba moved the gauge keyframe")
    gt = seq.poses[:, :3, 3]
    ate_ref = trajectory.ate_rmse(slam7.refined_trajectory()[:, :3, 3], gt)
    print(f"[global_ba] SLAM.run_global_ba on phase 7's map ({n_cams} "
          f"keyframes, 640x480): cost {[round(x, 3) for x in run_costs]}, "
          f"the gauge keyframe (slot {g}) bit-unchanged; host ms to the end "
          f"of the call (problem build, solve, write-back, costs read): "
          f"eager solve {eager_ms:.1f}, first call {calls[0][0]} (eager, the "
          f"shape's first solve; 0 captures), second call {calls[1][0]} "
          f"(capture and replay; 1 capture), third call {calls[2][0]} (a "
          f"replay, 0 captures); all three bit-equal to the eager solve (map "
          f"and costs); refined ATE "
          f"{ate_ref * 1e3:.2f} mm (phase 7: online {ate7[0] * 1e3:.2f} mm, "
          f"refined by local BA {ate7[1] * 1e3:.2f} mm); {smi}", flush=True)
    return dict(eager=_solve_rows(out, costs, stats), map_before=map_before,
                map_after=convert.map_to_numpy(m), run_costs=run_costs,
                gauge_slot=g)


def _solve_rows(out, costs, stats) -> dict:
    """A global solve's cameras, landmarks, costs and stats on the host."""
    return dict(cam_q=out.cam_q.cpu(), cam_t=out.cam_t.cpu(),
                mp_pos=out.mp_pos.cpu(), costs=costs.cpu(),
                accepted=stats.accepted.cpu(), retries=stats.retries.cpu(),
                pcg_iters=stats.pcg_iters.cpu(), lam=stats.lam.cpu())


def _render_streams(n, frames):
    """n sequences of 640x480 (seeds 0..n-1), rendered in n processes."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from kbslam_torch.io.synthetic import render_sequence

    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(n, os.cpu_count() or 1),
                             mp_context=ctx) as pool:
        futs = [pool.submit(render_sequence, num_frames=frames, height=480,
                            width=640, seed=s) for s in range(n)]
        return [f.result() for f in futs]


def _kernel_sum(fn):
    """One call of ``fn`` under torch.profiler: (summed kernel ms,
    kernels). Kernels that overlap on side streams add up here."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.device_time for e in kernels) / 1e3, len(kernels)


def _stream_digests(outs, state, first=0) -> list:
    """SHA-256 of every stream's rows of a run: its outputs of every frame
    (a list of stream-batched ``TrackOutput``) and its final state; the
    streams numbered globally from ``first``."""
    import hashlib

    def leaves(st):
        return list(st.map) + list(st[1:])

    digests = []
    for i in range(state.pose_q.shape[0]):
        h = hashlib.sha256()
        for t in [x for o in outs for x in o] + leaves(state):
            h.update(t[i].contiguous().cpu().numpy().tobytes())
        digests.append((first + i, h.hexdigest()))
    return digests


def _graph_of(program):
    """The one CUDA graph a batched multistream program captured."""
    (call,) = program.graphs.graphs.values()
    return call.graph


def _first_gap(outs_a, outs_b, state_a, state_b, i):
    """Where stream i of two runs first differs: (frame, field) or
    (None, field of the final state) or None; and the largest gaps
    between the two runs' camera poses over the frames (metres,
    degrees)."""
    gap = (max(float((a.pose_t[i] - b.pose_t[i]).norm())
               for a, b in zip(outs_a, outs_b)),
           max(float(_angle_deg(a.pose_q[i:i + 1].cpu(),
                                b.pose_q[i:i + 1].cpu())[0])
               for a, b in zip(outs_a, outs_b)))
    for t, (a, b) in enumerate(zip(outs_a, outs_b)):
        for name, x, y in zip(a._fields, a, b):
            if not torch.equal(x[i], y[i]):
                return (t, name), gap
    names = [f"map.{f}" for f in state_a.map._fields] + list(
        state_a._fields[1:])
    leaves = zip(names, list(state_a.map) + list(state_a[1:]),
                 list(state_b.map) + list(state_b[1:]))
    for name, x, y in leaves:
        if not torch.equal(x[i], y[i]):
            return (None, name), gap
    return None, gap


def _deferred_gates(kfs_d, kfs_i, num_mp_d, ninl_d, ninl_i, what):
    """tests/test_parallel.py:95-156's deferred-scan gates against the
    immediate run; returns (tracked share deferred, immediate)."""
    ok_d, ok_i = (ninl_d[2:] > 0).mean(), (ninl_i[2:] > 0).mean()
    if not ((kfs_d >= 2).all() and (np.abs(kfs_d - kfs_i) <= 1).all()
            and (num_mp_d > 0).all() and ok_d >= ok_i - 0.15
            and ninl_d[2:].mean() >= 0.7 * ninl_i[2:].mean()):
        raise AssertionError(
            f"{what} deferred scan gates: keyframes {kfs_d} vs {kfs_i}, "
            f"tracked {ok_d} vs {ok_i}, inliers {ninl_d[2:].mean()} vs "
            f"{ninl_i[2:].mean()}")
    return ok_d, ok_i


def _tracking_gates(outs, final, gt, what):
    """Every stream tracked with >= MIN_INLIERS inliers after frame 0,
    >= 2 keyframes per stream, each stream's ATE against the rendered
    ground truth (gt [S, T, 3]) under MAX_ATE_M. Returns (min inliers,
    keyframes, ATE per stream in metres)."""
    from kbslam_torch.eval import trajectory

    ok = torch.stack([o.success for o in outs[1:]]).cpu()
    inl = torch.stack([o.num_inliers for o in outs[1:]]).cpu()
    if not (ok.all() and (inl >= MIN_INLIERS).all()):
        raise AssertionError(f"{what}: a stream failed or fell under "
                             f"{MIN_INLIERS} inliers: min {inl.min(0)}")
    kfs = final.map.num_kf.cpu()
    if not (kfs >= 2).all():
        raise AssertionError(f"{what}: keyframes {kfs.tolist()}")
    est = torch.stack([o.pose_t for o in outs], 1).cpu().numpy()  # [S, T, 3]
    ate = [trajectory.ate_rmse(est[i], gt[i]) for i in range(len(gt))]
    if max(ate) >= MAX_ATE_M:
        raise AssertionError(f"{what}: ATE per stream {ate}")
    return int(inl.min()), kfs.numpy(), ate


def _timed_steps(step, state, rgb, dep):
    """Every frame through ``step``: (outputs, final state, warm state
    after frame 0, ms per step over steps 2..T on the device's clock,
    device busy share, host s of the first call)."""
    T = rgb.shape[0]
    outs, begins, ends = [], [], []
    t0 = time.perf_counter()
    for t in range(T):
        begins.append(torch.cuda.Event(enable_timing=True))
        begins[-1].record()
        state, out = step(state, rgb[t], dep[t])
        outs.append(out)
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()
        if t == 0:
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            warm = _clone_state(state)
    torch.cuda.synchronize()
    # the time the stream waited between one step's end and the next
    # one's first copy is idle
    total = ends[0].elapsed_time(ends[-1])
    idle = sum(ends[t - 1].elapsed_time(begins[t]) for t in range(1, T))
    return (outs, _clone_state(state), warm, total / (T - 1),
            1.0 - idle / total, first_s)


def _clone_state(state):
    from kbslam_torch.pipeline import clone_state

    return clone_state(state)


def _timed_scan(scan, warm, rgb, dep, **kw):
    """One run of a deferred scan from a copy of ``warm``: (final state,
    inlier counts [T, S], ms per frame of all streams, CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    st_d, ninl_d = scan(_clone_state(warm), rgb, dep, **kw)
    end.record()
    torch.cuda.synchronize()
    return (_clone_state(st_d), ninl_d.clone(),
            start.elapsed_time(end) / rgb.shape[0])


def _same_state(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in
               zip(list(a.map) + list(a[1:]), list(b.map) + list(b[1:])))


def multistream_phase(dev, smi, pace):
    """(19) Config 4: 8 streams of 640x480 at SLAMConfig(), immediate and
    deferred (apply_every 4): the batched program (one CUDA graph per
    step and per block of K frames, the describe kernel once per step
    over all 8 x 3072 keypoints) held to the tracking gates, then the
    per-stream graphs (side streams, serially) as the yardstick, and the
    batched run against them stream by stream. Returns the describe
    launches ((single-stream, batched)), and for phase 22 the frames, the
    ground truth and each stream's digests of the runs."""
    from kbslam_torch import config
    from kbslam_torch.geom.camera import Intrinsics
    from kbslam_torch.ops import describe as describe_ops
    from kbslam_torch.parallel.multistream import (batched_init_state,
                                                   make_multistream_scan,
                                                   make_multistream_step,
                                                   make_perstream_scan,
                                                   make_perstream_step,
                                                   stream_state)
    from kbslam_torch.pipeline import init_state, track_step
    from kbslam_torch.pnp.ransac import hash_sampler

    S, T, K = MS_STREAMS, MS_FRAMES, MS_K
    t0 = time.perf_counter()
    seqs = _render_streams(S, T)
    render_s = time.perf_counter() - t0
    cfg = config.SLAMConfig()
    intr = Intrinsics.from_matrix(seqs[0].K)
    rgb = torch.from_numpy(np.stack([np.stack([s.rgb[t] for s in seqs])
                                     for t in range(T)])).pin_memory()
    dep = torch.from_numpy(np.stack([np.stack([s.depth[t] for s in seqs])
                                     for t in range(T)]).astype(np.int32)
                           ).pin_memory()
    gt = np.stack([s.poses[:, :3, 3] for s in seqs])
    seq_K = seqs[0].K
    del seqs

    # (a) the batched program: the main path of this phase, with the
    # kernel counts at 0 just before it and read just after
    reset_launch_counts()
    step = make_multistream_step(cfg, intr, S)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    outs, final, warm, ms_b, busy_b, cap_s = _timed_steps(
        step, batched_init_state(cfg, S, dev), rgb, dep)
    peak_b = (torch.cuda.max_memory_allocated() - base) / 1e9
    scan = make_multistream_scan(cfg, intr, S, apply_every=K)
    t1 = time.perf_counter()
    st_c, ninl_c, ms_dc = _timed_scan(scan, warm, rgb[1:], dep[1:])
    scan_cap_s = time.perf_counter() - t1
    st_d, ninl_d, ms_d = _timed_scan(scan, warm, rgb[1:], dep[1:])
    eager_b = describe_ops.launches
    replays_b = (step.program.replays, scan.program.replays)
    if not (torch.equal(ninl_c, ninl_d) and _same_state(st_c, st_d)):
        raise AssertionError("batched scan: the replays != the capture run")
    p_step = _replay_profile(_graph_of(step.program))
    p_block = _replay_profile(_graph_of(scan.program))
    if (p_step[3], p_block[3]) != (1, K):
        raise AssertionError(f"batched describe kernels: step {p_step[3]}, "
                             f"block {p_block[3]} (expected 1, {K})")
    batched = eager_b + replays_b[0] * p_step[3] + replays_b[1] * p_block[3]
    if batched == 0:
        raise AssertionError("the batched path launched no describe kernel")
    inl_min, kfs, ate = _tracking_gates(outs, final, gt, "batched")
    ninl_i = torch.stack([o.num_inliers for o in outs[1:]]).cpu().numpy()
    kfs_d = st_d.map.num_kf.cpu().numpy()
    ok_d, ok_i = _deferred_gates(kfs_d, kfs, st_d.map.num_mp.cpu().numpy(),
                                 ninl_d.cpu().numpy(), ninl_i, "batched")
    print(f"[multistream] config 4, batched: {S} streams of 640x480 (seeds "
          f"0-{S - 1}, rendered in {render_s:.1f} s), SLAMConfig(), {T} "
          f"frames each, one CUDA graph per step over the stacked state: "
          f"every stream tracked with >= {MIN_INLIERS} inliers after frame 0"
          f" (min {inl_min}), keyframes {kfs.tolist()}, ATE per stream "
          f"{[round(a * 1e3, 2) for a in ate]} mm; immediate {ms_b:.2f} ms "
          f"per step of all {S} streams = {S * 1e3 / ms_b:.1f} frames/s (CUDA"
          f" events, steps 2-{T}), device busy {busy_b:.1%}; one step replay "
          f"{p_step[1]} kernel nodes, {p_step[2]:.2f} ms kernel time, "
          f"{p_step[3]} describe kernel ({p_step[4]:.4f} ms), top {p_step[5]}"
          f"; first call (warm-up and capture) {cap_s:.2f} s; peak device "
          f"memory {peak_b:.3f} GB; deferred (apply_every {K}, from frame "
          f"0's warm start, frames 1-{T - 1}): keyframes {kfs_d.tolist()}, "
          f"tracked {ok_d:.3f} (immediate {ok_i:.3f}), {ms_d:.2f} ms per "
          f"frame of all {S} streams = {S * 1e3 / ms_d:.1f} frames/s (first "
          f"run, with the capture, {ms_dc:.2f} ms, {scan_cap_s:.2f} s); one "
          f"block replay {p_block[1]} kernel nodes, {p_block[2]:.2f} ms, "
          f"{p_block[3]} describe kernels; the replays bit-equal to the "
          f"capture run; describe launches {batched} = {eager_b} eager "
          f"(warm-ups) + {replays_b[0]} step replays x {p_step[3]} + "
          f"{replays_b[1]} block replays x {p_block[3]}; {smi}", flush=True)

    # (b) the yardstick: one graph per stream on side streams (the first
    # call captures), then the same frames replayed serially
    describe_ops.reset_launches()
    pstep = make_perstream_step(cfg, intr, S)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    runs = {}
    for serial in (False, True):
        def one(st, r, d, serial=serial):
            return pstep(st, r, d, serial=serial)
        runs[serial] = _timed_steps(one, batched_init_state(cfg, S, dev), rgb,
                                    dep)
        if not serial:
            peak_p = (torch.cuda.max_memory_allocated() - base) / 1e9
    outs_p, final_p, warm_p, ms_side, busy_side, _ = runs[False]
    ms_serial, busy_serial = runs[True][3:5]
    if not (all(torch.equal(a, b) for o1, o2 in zip(outs_p, runs[True][0])
                for a, b in zip(o1, o2))
            and _same_state(final_p, runs[True][1])):
        raise AssertionError("per-stream: serial replays != side streams")
    _tracking_gates(outs_p, final_p, gt, "per-stream")
    # two streams against their single-stream runs (the same draws)
    for i in (0, S - 1):
        st = init_state(cfg, dev)
        for t in range(T):
            st, o = track_step(st, rgb[t, i].to(dev), dep[t, i].to(dev), None,
                               intr, cfg,
                               hash_sampler(0, st.frame_count * S + i))
            if not all(torch.equal(a, b[i]) for a, b in zip(o, outs_p[t])):
                raise AssertionError(f"stream {i} frame {t} != its "
                                     "single-stream run")
        if not _same_state(st, stream_state(final_p, i)):
            raise AssertionError(f"stream {i}'s state != its single run")
    pscan = make_perstream_scan(cfg, intr, S, apply_every=K)
    res = {name: _timed_scan(pscan, warm_p, rgb[1:], dep[1:], serial=serial)
           for name, serial in (("capture", False), ("side", False),
                                ("serial", True))}
    pst_d, pninl_d, ms_p_side = res["side"]
    for other in ("capture", "serial"):
        if not (torch.equal(pninl_d, res[other][1])
                and _same_state(pst_d, res[other][0])):
            raise AssertionError(f"per-stream scan: {other} run != side")
    _deferred_gates(pst_d.map.num_kf.cpu().numpy(),
                    final_p.map.num_kf.cpu().numpy(),
                    pst_d.map.num_mp.cpu().numpy(), pninl_d.cpu().numpy(),
                    torch.stack([o.num_inliers for o in outs_p[1:]]).cpu()
                    .numpy(), "per-stream")
    n_step = _replay_profile(pstep.streams._graphs[0])[3]
    n_block = _replay_profile(pscan.streams._graphs[0])[3]
    if (n_step, n_block) != (1, K):
        raise AssertionError(f"describe kernels per stream graph: step "
                             f"{n_step}, block {n_block} (expected 1, {K})")
    eager_p = describe_ops.launches
    summed, n_kern = _kernel_sum(lambda: pstep(final_p, rgb[-1], dep[-1]))
    single = (eager_p + pstep.streams.replays * S * n_step
              + pscan.streams.replays * S * n_block)

    # (c) the batched run against the yardstick, stream by stream
    same = []
    for i in range(S):
        where, gap = _first_gap(outs, outs_p, final, final_p, i)
        same.append(f"{i}: " + ("bit-equal" if where is None else
                                f"first differs at frame {where[0]} in "
                                f"{where[1]}")
                    + f", largest pose gap {gap[0] * 1e3:.3f} mm, "
                    f"{gap[1]:.4f} deg")
    print(f"[multistream] config 4, per-stream yardstick (one CUDA graph "
          f"per stream): serial replays bit-equal to the side streams, "
          f"streams 0 and {S - 1} bit-equal to their single-stream runs, the "
          f"tracking and deferred gates hold; immediate {ms_side:.2f} ms per "
          f"step on side streams = {S * 1e3 / ms_side:.1f} frames/s, serial "
          f"{ms_serial:.2f} ms = {S * 1e3 / ms_serial:.1f} frames/s; device "
          f"busy {busy_side:.1%} / {busy_serial:.1%}; one step of all {S} "
          f"graphs {n_kern} kernels, {summed:.2f} ms summed kernel time; "
          f"deferred {ms_p_side:.2f} ms per frame on side streams = "
          f"{S * 1e3 / ms_p_side:.1f} frames/s (serial "
          f"{res['serial'][2]:.2f} ms); peak device memory {peak_p:.3f} GB; "
          f"describe launches {single} = {eager_p} eager + "
          f"{pstep.streams.replays} step replays x {S} x {n_step} + "
          f"{pscan.streams.replays} block replays x {S} x {n_block}; phase "
          f"10's single stream {pace['ms_frame']:.2f} ms/frame; batched "
          f"against per-stream, stream by stream: {'; '.join(same)}; {smi}",
          flush=True)
    ninl_rows = ninl_d.cpu().movedim(1, 0)
    pninl_rows = pninl_d.cpu().movedim(1, 0)
    return (single, batched), dict(
        rgb=rgb, dep=dep, K=seq_K, gt=gt,
        immediate=_stream_digests(outs, final),
        deferred=_stream_digests([(ninl_rows,)], st_d),
        perstream_immediate=_stream_digests(outs_p, final_p),
        perstream_deferred=_stream_digests([(pninl_rows,)], pst_d))


class _CountedCull:
    """Wraps a shell's keyframe cull: keyframes culled, read on the
    host after each call."""

    def __init__(self, fn):
        self.fn, self.culled = fn, 0

    def __call__(self, m):
        before = int((m.kf_id >= 0).sum())
        m = self.fn(m)
        self.culled += before - int((m.kf_id >= 0).sum())
        return m


def longrun_phase(dev, smi):
    """(20) tests/test_longrun.py on the card: 200 palindrome frames of
    a 25-frame 120x160 sequence on a 6-keyframe, 512-landmark map with
    async BA (window 3, 5 trips) and culling, through SLAM and through
    ChunkedStream (chunk 8), held to that test's gates."""
    import dataclasses

    from kbslam_torch import config
    from kbslam_torch.geom.camera import Intrinsics
    from kbslam_torch.io.synthetic import render_sequence
    from kbslam_torch.pipeline import init_state
    from kbslam_torch.slam import SLAM
    from kbslam_torch.streaming import ChunkedStream

    seq = render_sequence(num_frames=25, height=120, width=160, fx=130.0)
    order = list(range(25)) + list(range(23, 0, -1))
    frames = [order[i % len(order)] for i in range(200)]
    cfg = config.SLAMConfig(
        image_height=120, image_width=160,
        orb=config.OrbConfig(num_features=256, num_levels=3,
                             max_features=256),
        pnp=config.PnPConfig(num_hypotheses=64),
        map=config.MapConfig(max_keyframes=6, max_map_points=512),
        ba=config.BAConfig(window=3, compact_obs=512, compact_landmarks=512,
                           max_iterations=5))
    cfg = cfg.replace(cull=dataclasses.replace(cfg.cull, enabled=True))
    cap_kf, cap_mp = cfg.map.max_keyframes, cfg.map.max_map_points

    def gates(what, n_success, n_kf, m, max_t, stats):
        finite = all(bool(torch.isfinite(a).all())
                     for a in (m.kf_q, m.kf_t, m.mp_pos))
        num_mp = int(m.num_mp)
        if not (n_success > 150 and n_kf > 12 and num_mp > 100 and finite
                and max_t < 10.0 and len(stats) >= 3
                and all(np.isfinite(s["final_cost"]) for s in stats)):
            raise AssertionError(
                f"longrun {what}: {n_success} tracked, {n_kf} keyframes, "
                f"{num_mp} landmarks, finite {finite}, max |t| {max_t} m, "
                f"{len(stats)} solves")
        return num_mp

    slam = SLAM(cfg, seq.K, ba_mode="async", use_mask=False, device=dev)
    slam._cull = _CountedCull(slam._cull)
    t0 = time.perf_counter()
    for j in frames:
        slam.process(seq.rgb[j], seq.depth[j])
    slam.finish()
    wall = (time.perf_counter() - t0) * 1e3 / len(frames)
    d = slam.diagnostics
    n_kf = slam.num_keyframes
    max_t = float(np.abs(np.stack(slam.frame_poses)[:, :3, 3]).max())
    num_mp = gates("per frame", sum(x["success"] for x in d), n_kf,
                   slam.state.map, max_t, slam.ba_stats)
    merged = sum(x["ran_ba"] for x in d)
    print(f"[longrun] per frame, {len(frames)} palindrome frames of 25 at "
          f"120x160, ring of {cap_kf} keyframes and {cap_mp} landmarks, async"
          f" BA and cull: {sum(x['success'] for x in d)} tracked, {n_kf} "
          f"keyframes (the ring wrapped {n_kf // cap_kf} times), {num_mp} "
          f"landmarks (the landmark ring wrapped {num_mp // cap_mp} times), "
          f"{len(slam.ba_stats)} solves ({merged} merged while tracking), "
          f"{slam._cull.culled} keyframes culled, max |t| {max_t:.3f} m, "
          f"state finite; {wall:.1f} ms/frame; {smi}", flush=True)

    cs = ChunkedStream(cfg, Intrinsics.from_matrix(seq.K),
                       init_state(cfg, dev), chunk=8, ba_mode="async")
    cs._cull = _CountedCull(cs._cull)
    got = []
    t0 = time.perf_counter()
    for j in frames:
        got += cs.feed(seq.rgb[j], seq.depth[j])
    got += cs.flush()
    wall = (time.perf_counter() - t0) * 1e3 / len(frames)
    if len(got) != len(frames):
        raise AssertionError(f"longrun chunked: {len(got)} results")
    n_kf = sum(r["added_kf"] for r in got)
    max_t = float(np.abs(np.stack([r["pose_t"] for r in got])).max())
    num_mp = gates("chunked", sum(r["success"] for r in got), n_kf,
                   cs.state.map, max_t, cs.ba_stats)
    print(f"[longrun] chunked (chunk 8, {cs.replays} graph replays): "
          f"{sum(r['success'] for r in got)} tracked, {n_kf} keyframes (the "
          f"ring wrapped {n_kf // cap_kf} times), {num_mp} landmarks (the "
          f"landmark ring wrapped {num_mp // cap_mp} times), "
          f"{len(cs.ba_stats)} solves merged, {cs._cull.culled} keyframes "
          f"culled, max |t| {max_t:.3f} m, state finite; {wall:.1f} ms/frame;"
          f" {smi}", flush=True)


# --- 21: the reference's ingress and egress; the end-to-end gates ------

CLI_FRAMES = ["--frames", str(FRAMES), "--width", "640", "--height", "480"]
LOOPBACK_FRAMES = 16   # frames through the zmq loopback (where pyzmq is)


@contextlib.contextmanager
def _patched(cls, name, wrap):
    """``cls.name`` replaced by ``wrap(original)`` inside the block."""
    orig = cls.__dict__[name]
    setattr(cls, name, wrap(orig))
    try:
        yield
    finally:
        setattr(cls, name, orig)


def _instances(cls):
    """(context patching ``cls.__init__``, the list of instances it made)."""
    made = []

    def wrap(init):
        def init_(self, *a, **k):
            init(self, *a, **k)
            made.append(self)
        return init_
    return _patched(cls, "__init__", wrap), made


def _cli(args):
    """``kbslam_torch.cli.main(args)`` with its stdout kept out of this
    script's; returns the summary it printed."""
    import io

    from kbslam_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(args)
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _same_run(a, b, what):
    """Two CLI runs: equal trajectory files and summaries, timings aside."""
    (sa, ta), (sb, tb) = a, b
    drop = ("mean_track_ms", "streaming_fps")
    sa = {k: v for k, v in sa.items() if k not in drop}
    sb = {k: v for k, v in sb.items() if k not in drop}
    if sa != sb or ta != tb:
        raise AssertionError(f"{what}: viewer on != off ({sa} vs {sb}; "
                             f"trajectories equal: {ta == tb})")


def _viewer_counts(viewer_cls):
    """(patch contexts counting and timing the viewer's logging calls,
    {method: [host ms]})."""
    calls = {m: [] for m in ("update", "update_dense", "update_rendered",
                             "update_dense_mesh")}

    def wrap_for(m):
        def wrap(fn):
            def timed(self, *a, **k):
                t = time.perf_counter()
                try:
                    return fn(self, *a, **k)
                finally:
                    calls[m].append((time.perf_counter() - t) * 1e3)
            return timed
        return wrap
    return [_patched(viewer_cls, m, wrap_for(m)) for m in calls], calls


def io_cli_per_frame(dev, smi, traj_dir):
    """(21a) The CLI per frame at 640x480 with BA and the dense volume,
    viewer on against off; returns the describe launches."""
    from kbslam_torch.mapping import raycast
    from kbslam_torch.utils.profiling import sync_sites
    from kbslam_torch.slam import SLAM
    from kbslam_torch.viz import rerun_viewer

    runs, launches = {}, 0
    for name, extra in (("off", ["--viewer", "none"]),
                        ("on", ["--viewer", "rerun", "--viewer-every", "1"])):
        traj = os.path.join(traj_dir, f"per_frame_{name}.txt")
        starts = []

        def wrap(fn):
            def process(self, *a, **k):
                starts.append(time.perf_counter())
                return fn(self, *a, **k)
            return process
        made_ctx, made = _instances(SLAM)
        view_ctx, calls = _viewer_counts(rerun_viewer.Viewer)
        summary = []
        with contextlib.ExitStack() as stack:
            for c in [made_ctx, _patched(SLAM, "process", wrap), *view_ctx]:
                stack.enter_context(c)
            reset_launch_counts()
            sites = sync_sites(lambda: summary.append(_cli(
                [*CLI_FRAMES, "--ba", "on", "--dense",
                 "--save-trajectory", traj, *extra])))
            launches += check_shell_launches("CLI per frame", FRAMES)
        slam = made[0]
        # a frame's whole iteration: process, the viewer, the log line
        it_ms = np.diff(starts) * 1e3
        no_solve = [ms for ms, d in zip(it_ms, slam.diagnostics[:-1])
                    if d["frame"] > 0 and not d["ran_ba"]]
        with open(traj) as f:
            runs[name] = (summary[0], f.read())
        runs[name + "_stats"] = (float(np.median(no_solve)), len(no_solve),
                                 sum(sites.values()), sites.most_common(4),
                                 {k: len(v) for k, v in calls.items()},
                                 {k: round(float(np.median(v)), 3)
                                  for k, v in calls.items() if v}, slam)
    _same_run(runs["on"], runs["off"], "per frame")
    slam = runs["on_stats"][-1]
    # the viewer's map readout and its stride-4 render, on the final map
    m = slam.state.map
    read_bytes = sum(t.numel() * t.element_size()
                     for t in (m.kf_id, m.kf_t, m.kf_mp, m.mp_pos, m.num_mp))
    walls = []
    for _ in range(20):
        torch.cuda.synchronize()
        t = time.perf_counter()
        slam.keyframe_positions()
        slam.map_points()
        walls.append((time.perf_counter() - t) * 1e3)
    read_syncs = sum(sync_sites(lambda: (slam.keyframe_positions(),
                                         slam.map_points())).values())
    q, t, _ = slam._last_view()
    vol, pose, _ = raycast.resolve_render_model(slam.tsdf, None, m, q, t)
    intr_s, h, w = slam._scaled_intr(4)
    rc = raycast.make_raycast(slam.dense_cfg, intr_s, h, w)
    r = rc(vol, pose.q, pose.t)
    ref = slam.render_view(stride=4)
    if not torch.equal(r.depth, ref.depth):
        raise AssertionError("the timed render != the viewer's render_view")
    render_ms = cuda_ms(lambda: rc(vol, pose.q, pose.t))
    render_host = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slam.render_view(stride=4).depth.cpu()
        render_host.append((time.perf_counter() - t0) * 1e3)
    frames = len(slam.diagnostics)
    off, on = runs["off_stats"], runs["on_stats"]
    from kbslam_torch.viz.rerun_viewer import HAVE_RERUN
    print(f"[io] CLI per frame, {frames} frames 640x480, --ba on --dense, "
          f"--viewer rerun --viewer-every 1 against --viewer none: "
          f"trajectories and summaries equal; HAVE_RERUN {HAVE_RERUN}; "
          f"median ms of a frame's CLI iteration without a solve: viewer off "
          f"{off[0]:.2f} ({off[1]} frames), on {on[0]:.2f} ({on[1]} frames); "
          f"host syncs per frame over the whole CLI run: off "
          f"{off[2] / frames:.2f} ({off[2]} in all), on {on[2] / frames:.2f} "
          f"({on[2]} in all; top sites {on[3]}); viewer calls {on[4]}, their "
          f"median host ms {on[5]}; one readout of keyframes and landmarks "
          f"(keyframe_positions + map_points): median "
          f"{np.median(walls):.3f} ms host, {read_syncs} host syncs, "
          f"{read_bytes} bytes copied; the stride-4 render ({h}x{w}): "
          f"{render_ms:.4f} ms device (CUDA graph of 20 calls), "
          f"render_view host ms median {np.median(render_host):.3f}; {smi}",
          flush=True)
    return launches


def io_cli_chunked(dev, smi, traj_dir, pace):
    """(21b) The CLI chunked (chunk 8, the dense volume), viewer on
    against off: with async BA, each solve merged at the next keyframe
    tick (waiting for it, as phase 15 does) so that both runs merge at
    the same drained frames whatever the viewer's reads cost; and with BA
    off, where nothing but the viewer's reads holds the pipeline. Returns
    the describe launches."""
    from kbslam_torch.ops import describe as describe_ops
    from kbslam_torch.streaming import ChunkedStream

    launches, full, lines = 0, FRAMES // CHUNK, []
    for ba in ("async", "off"):
        runs = {}
        for name, extra in (("off", ["--viewer", "none"]),
                            ("on", ["--viewer", "rerun"])):
            traj = os.path.join(traj_dir, f"chunked_{ba}_{name}.txt")
            ends, made = [], []

            def wrap(init, ends=ends, made=made):
                def init_(self, *a, **k):
                    init(self, *a, **k)
                    dispatch = self._dispatch

                    def timed(n):
                        dispatch(n)
                        ends.append(torch.cuda.Event(enable_timing=True))
                        ends[-1].record()
                    self._dispatch = timed
                    if self._async is not None:
                        self._async.ready = lambda a=self._async: (
                            a.inflight is not None)
                    made.append(self)
                return init_
            describe_ops.reset_launches()
            with _patched(ChunkedStream, "__init__", wrap):
                summary = _cli([*CLI_FRAMES, "--chunk", str(CHUNK), "--ba",
                                ba, "--dense", "--save-trajectory", traj,
                                *extra])
            cs = made[0]
            del cs._dispatch    # the methods again, and no reference cycle
            if cs._async is not None:
                del cs._async.ready
            launches += describe_ops.launches + cs.replays * CHUNK
            torch.cuda.synchronize()
            steady = ends[0].elapsed_time(ends[full - 1]) / ((full - 1)
                                                             * CHUNK)
            replay_ms = eager_ms(cs._graph.replay, iters=3, warmup=1)
            with open(traj) as f:
                runs[name] = (summary, f.read())
            runs[name + "_pace"] = (steady, replay_ms / (steady * CHUNK),
                                    cs.replays, summary["ba_runs"])
        _same_run(runs["on"], runs["off"], f"chunked, --ba {ba}")
        off, on = runs["off_pace"], runs["on_pace"]
        lines.append(f"--ba {ba}: steady ms/frame off {off[0]:.3f}, on "
                     f"{on[0]:.3f}, device busy off {off[1]:.1%}, on "
                     f"{on[1]:.1%}, graph replays {off[2]} / {on[2]}, solves "
                     f"{off[3]} / {on[3]}")
    print(f"[io] CLI chunked, {FRAMES} frames 640x480, --chunk {CHUNK} "
          f"--dense, --viewer rerun (one update per chunk) against --viewer "
          f"none, drained results equal; steady ms/frame by CUDA events after "
          f"each dispatch (chunks 2-{full}), device busy = a replay alone / "
          f"steady ms per chunk; {'; '.join(lines)} (--ba async: each solve "
          f"merged at the next keyframe tick); phase 10's pace (ba off, no "
          f"dense, no viewer) {pace['ms_frame']:.3f} ms/frame, "
          f"{pace['busy']:.1%} busy; {smi}", flush=True)
    return launches


def _loopback(seq_frames, K, traj, extra, wire="raw"):
    """FramePublisher -> ZMQCamera -> the CLI on a free port, one frame at
    a time; returns the summary."""
    import threading

    import zmq

    from kbslam_torch.io import zmq_camera

    pub = zmq_camera.FramePublisher("tcp://127.0.0.1:*", wire=wire)
    ep = pub._sock.getsockopt(zmq.LAST_ENDPOINT).decode()
    grabbed = threading.Semaphore(0)
    cams_ctx, cams = _instances(zmq_camera.ZMQCamera)

    def wrap(grab):
        def grab_(self, *a, **k):
            try:
                return grab(self, *a, **k)
            finally:
                grabbed.release()
        return grab_

    def feed():
        while not (cams and cams[0]._k_ready.is_set()):
            pub.publish_intrinsics(K)
            time.sleep(0.05)
        for rgb, depth in seq_frames:
            pub.publish_frame(rgb, depth)
            grabbed.acquire(timeout=120)
        pub.publish_end()
    with cams_ctx, _patched(zmq_camera.ZMQCamera, "grab_frames", wrap):
        th = threading.Thread(target=feed, daemon=True)
        th.start()
        try:
            return _cli(["--source", f"zmq:{ep}", "--save-trajectory", traj,
                         *extra])
        finally:
            th.join(timeout=120)
            pub.close()


def io_wire_and_trace(dev, seq, smi, slice_poses, traj_dir):
    """(21c) The raw wire codec into SLAM, the zmq loopback where pyzmq
    is installed; (21d) ``utils.profiling.device_trace`` around 4 eager
    frames. Returns the describe launches."""
    from kbslam_torch import config
    from kbslam_torch.io.zmq_camera import _pack, _unpack
    from kbslam_torch.slam import SLAM
    from kbslam_torch.utils.profiling import TRACE_FILE, device_trace

    reset_launch_counts()
    slam = SLAM(config.SLAMConfig(), seq.K, ba_mode="disabled", device=dev)
    wire_bytes = 0
    for i in range(FRAMES):
        frame = []
        for a in (seq.rgb[i], seq.depth[i], seq.mask[i]):
            buf = _pack(a)
            wire_bytes += len(buf)
            b = _unpack(buf)
            if b.dtype != a.dtype or not np.array_equal(a, b):
                raise AssertionError(f"wire codec changed frame {i}")
            frame.append(b)
        slam.process(frame[0], frame[1])
    launches = check_shell_launches("wire codec", FRAMES)
    got = np.stack(slam.frame_poses)
    if not np.array_equal(got, slice_poses):
        raise AssertionError("trajectory through the wire codec != phase 5's")
    print(f"[io] raw wire codec (_pack then _unpack of rgb, depth and mask, "
          f"{wire_bytes} bytes) into SLAM, {FRAMES} frames 640x480, BA off: "
          f"trajectory bit-equal to phase 5's direct feed; {smi}", flush=True)
    try:
        import zmq
    except ImportError:
        print("[io] zmq absent: loopback not run (FramePublisher -> "
              "ZMQCamera -> CLI needs pyzmq)", flush=True)
    else:
        from kbslam_torch.io.synthetic import render_sequence

        try:
            import google.protobuf  # noqa: F401
            wires = ("raw", "proto")
        except ImportError:
            wires = ("raw",)
        n = LOOPBACK_FRAMES
        cseq = render_sequence(num_frames=n, height=480, width=640,
                               fx=525.0)
        b = os.path.join(traj_dir, "loopback_ref.txt")
        _cli(["--frames", str(n), *CLI_FRAMES[2:], "--ba", "off",
              "--save-trajectory", b])
        with open(b) as f:
            ref = f.read()
        for wire in wires:
            a = os.path.join(traj_dir, f"loopback_{wire}.txt")
            reset_launch_counts()
            s = _loopback(zip(cseq.rgb, cseq.depth), cseq.K, a,
                          ["--ba", "off", *CLI_FRAMES[2:]], wire)
            launches += check_shell_launches(f"zmq loopback ({wire})", n)
            with open(a) as f:
                if s["frames"] != n or f.read() != ref:
                    raise AssertionError(f"zmq loopback ({wire}) != the "
                                         "synthetic source")
        print(f"[io] zmq loopback (pyzmq {zmq.__version__}; FramePublisher "
              f"-> ZMQCamera -> CLI, wire {' and '.join(wires)}"
              f"{'' if 'proto' in wires else ', protobuf absent'}): {n} "
              f"frames 640x480 to the end marker, trajectory equal to the "
              f"synthetic source's; {smi}", flush=True)

    # 21d: a torch.profiler trace of 4 frames (graph replays)
    reset_launch_counts()
    slam = SLAM(config.SLAMConfig(), seq.K, ba_mode="disabled", device=dev)
    slam.process(seq.rgb[0], seq.depth[0])      # capture, outside the trace
    with device_trace(device=dev) as log_dir:
        for i in range(1, 5):
            slam.process(seq.rgb[i], seq.depth[i])
    launches += check_shell_launches("device_trace", 5)
    path = os.path.join(log_dir, TRACE_FILE)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    size = os.path.getsize(path)
    shutil.rmtree(log_dir)
    kernels = [e for e in events if str(e.get("cat", "")).lower() == "kernel"]
    desc = [e for e in kernels if "describe" in e.get("name", "")]
    if len(desc) != 4:
        raise AssertionError(f"trace of 4 frames: {len(desc)} describe "
                             f"kernels among {len(kernels)}")
    print(f"[io] device_trace around 4 frames (graph replays): {TRACE_FILE} "
          f"({size} bytes, {len(events)} events, {len(kernels)} kernels, "
          f"{len(desc)} describe kernels, "
          f"{sum(e.get('dur', 0) for e in desc) / 4:.2f} us each); {smi}",
          flush=True)
    return launches


def _cfg240(config, **kw):
    """tests/test_slam.py's cfg240 (the port's config classes)."""
    return config.SLAMConfig(
        image_height=240, image_width=320,
        orb=config.OrbConfig(num_features=512, num_levels=4, max_features=512),
        pnp=config.PnPConfig(num_hypotheses=128),
        map=config.MapConfig(max_keyframes=kw.pop("max_kf", 16),
                             max_map_points=kw.pop("max_mp", 8192)), **kw)


def e2e_gates_phase(dev, smi):
    """(21e) tests/test_slam.py::test_slam_end_to_end (both BA modes) and
    the rotation-dominant case of tests/test_ba_in_loop.py on the card,
    with the port's own draws. Returns the describe launches."""
    from kbslam_torch import config
    from kbslam_torch.eval import trajectory
    from kbslam_torch.io import synthetic
    from kbslam_torch.slam import SLAM

    launches = 0
    seq = synthetic.render_sequence(num_frames=40, height=240, width=320)
    for mode in ("disabled", "on_keyframe"):
        reset_launch_counts()
        s = track(SLAM(_cfg240(config), seq.K, ba_mode=mode, use_mask=False,
                       device=dev), seq)
        launches += check_shell_launches("test_slam_end_to_end", 40)
        succ = sum(d["success"] for d in s.diagnostics)
        ate = trajectory.ate_rmse(np.stack(s.frame_poses)[:, :3, 3],
                                  seq.poses[:, :3, 3])
        n_mp, n_kfp = s.map_points().shape[0], s.keyframe_positions().shape[0]
        ok = (succ >= 38 and ate < 0.05 and s.num_keyframes >= 2
              and n_mp > 50 and n_kfp == min(s.num_keyframes, 16))
        if mode == "on_keyframe":
            ok = ok and len(s.ba_stats) >= 1 and all(
                st["final_cost"] <= st["initial_cost"] * 1.001
                for st in s.ba_stats)
        if not ok:
            raise AssertionError(
                f"test_slam_end_to_end[{mode}]: {succ} tracked, ATE {ate} m, "
                f"{s.num_keyframes} keyframes, {n_mp} landmarks, "
                f"{len(s.ba_stats)} solves")
        print(f"[e2e] tests/test_slam.py::test_slam_end_to_end[{mode}] at "
              f"240x320: {succ}/40 tracked, ATE {ate * 1e3:.2f} mm, "
              f"{s.num_keyframes} keyframes, {n_mp} landmarks, "
              f"{len(s.ba_stats)} solves; every gate of tests/test_slam.py:"
              f"28-41 holds; {smi}", flush=True)

    N = 120
    seq = synthetic.render_sequence(
        num_frames=N, height=240, width=320, seed=0,
        poses=synthetic.rotation_trajectory(N), scene="spheres",
        depth_noise_mm=2.0, depth_dropout=0.10, texture_rects=180)
    cfg = _cfg240(config, max_kf=32, max_mp=16384, track_keyframes=3)
    gt = seq.poses[:, :3, 3]
    ate, t0 = {}, time.perf_counter()
    for mode in ("disabled", "on_keyframe"):
        reset_launch_counts()
        s = track(SLAM(cfg, seq.K, ba_mode=mode, use_mask=False, device=dev),
                  seq)
        launches += check_shell_launches("rotation sweep", N)
        ate[mode] = trajectory.ate_rmse(np.stack(s.frame_poses)[:, :3, 3], gt)
    wall = time.perf_counter() - t0
    succ = sum(d["success"] for d in s.diagnostics)
    ate_ref = trajectory.ate_rmse(s.refined_trajectory()[:, :3, 3], gt)
    off, on = ate["disabled"], ate["on_keyframe"]
    if not (succ >= N - 6 and len(s.ba_stats) >= 6 and ate_ref <= on + 1e-3
            and ate_ref < 0.06):
        raise AssertionError(f"rotation sweep: {succ} tracked, "
                             f"{len(s.ba_stats)} solves, ATE on {on} m, "
                             f"refined {ate_ref} m")
    rel = on <= 1.05 * off + 1e-3
    print(f"[e2e] tests/test_ba_in_loop.py rotation-dominant sweep, {N} "
          f"frames 240x320, own draws: {succ}/{N} tracked, "
          f"{len(s.ba_stats)} solves, ATE BA off {off * 1e3:.2f} mm, on "
          f"{on * 1e3:.2f} mm, refined {ate_ref * 1e3:.2f} mm ({wall:.1f} s "
          f"for both runs); tracked, solves and both refined gates hold; the "
          f"relative gate on <= 1.05 x off + 1 mm (printed, not enforced: "
          f"the CPU test holds it on JAX's sets) {'holds' if rel else 'misses'}"
          f"; {smi}", flush=True)
    return launches


def io_phase(dev, seq, smi, pace, slice_poses) -> int:
    """(21) The reference's ingress and egress through both CLI paths, the
    wire codec, the trace context and the end-to-end gates; returns the
    describe launches of its runs."""
    import tempfile

    from kbslam_torch.io import synthetic

    traj_dir = tempfile.mkdtemp(prefix="kbslam_io_")
    render = synthetic.render_sequence
    memo = {}

    def cached(**kw):        # the CLI runs render the same 60 frames
        key = tuple(sorted(kw.items()))
        if key not in memo:
            memo[key] = render(**kw)
        return memo[key]
    synthetic.render_sequence = cached
    try:
        t0 = time.perf_counter()
        launches = io_cli_per_frame(dev, smi, traj_dir)
        launches += io_cli_chunked(dev, smi, traj_dir, pace)
    finally:
        synthetic.render_sequence = render
    launches += io_wire_and_trace(dev, seq, smi, slice_poses, traj_dir)
    launches += e2e_gates_phase(dev, smi)
    shutil.rmtree(traj_dir)
    print(f"[io] phase 21 took {time.perf_counter() - t0:.1f} s; describe "
          f"launches {launches}", flush=True)
    return launches


# 22. the multi-device paths over a process group of the machine's cards
DIST_DIMS = (512, 512, 512)      # the volume kbslam/mapping/dense.py:186-187 names
DIST_VOXEL_M = 0.016             # 8.19 m a side: the default box's x-y span
DIST_ORIGIN = (-4.096, -4.096, 0.2)
DIST_TIMEOUT_S = 400.0


def assert_no_jax():
    """Raise when this process loaded JAX or any module of kbslam/."""
    ref_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "kbslam") + os.sep
    loaded = [m for m, mod in list(sys.modules.items())
              if m == "jax" or m.startswith("jax.") or m == "kbslam"
              or m.startswith("kbslam.")
              or (getattr(mod, "__file__", None) or "").startswith(ref_dir)]
    if loaded:
        raise AssertionError(f"the port loaded JAX or kbslam/: {loaded}")


def _nbytes(counts) -> int:
    return sum(b for _, b in counts.values())


def _kernel_split(fn):
    """One call of ``fn`` under torch.profiler: (summed ms of the compute
    kernels, summed ms of the NCCL kernels, kernels). An NCCL kernel runs
    from its launch until every rank has joined, so its time holds the
    wait for the other ranks."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    nccl = sum(e.device_time for e in kernels if "nccl" in e.name.lower())
    total = sum(e.device_time for e in kernels)
    return (total - nccl) / 1e3, nccl / 1e3, len(kernels)


def _dist_global_ba(group, refs) -> dict:
    """(22a, one rank) Config 5 camera-sharded and landmark-sharded,
    eagerly: per solve host ms, device ms (CUDA events, and summed kernel
    time by torch.profiler, the NCCL kernels apart), collectives and
    bytes, and the bytes of one
    PCG trip (a solve with the cap one lower sends one trip less per
    retry); then ``SLAM.run_global_ba(group=)`` on phase 7's map."""
    from kbslam_torch import config, convert
    from kbslam_torch.ba import global_ba as gba
    from kbslam_torch.slam import SLAM

    dev = group.device
    data_cpu, intr, _ = global_ba_problem()
    shard = gba.shard_global_data(
        gba.GlobalBAData(*(x.to(dev) for x in data_cpu)), group)

    def solve(ls, cap=GBA_PCG):
        return gba.global_ba_solve(shard, intr, iters=GBA_ROUNDS,
                                   pcg_iters=cap, pcg_tol=GBA_TOL,
                                   max_retries=GBA_RETRIES,
                                   return_stats=True, group=group,
                                   landmark_sharded=ls)

    res = {}
    for name, ls in (("camera", False), ("landmark", True)):
        solve(ls)               # warm-up: the communicator, the allocator
        torch.cuda.synchronize()
        group.reset_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out, costs, stats = solve(ls)
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        end_ms = (time.perf_counter() - t0) * 1e3
        counts = {op: list(c) for op, c in group.counts.items()}
        kern_ms, nccl_ms, n_kern = _kernel_split(lambda: solve(ls))
        group.reset_counts()
        solve(ls, GBA_PCG - 1)
        torch.cuda.synchronize()
        trip = (_nbytes(counts) - _nbytes(group.counts)) / (GBA_ROUNDS
                                                           * GBA_RETRIES)
        # the same solve through its per-shape graph, collectives inside,
        # called three times (eager, capture and replay, replay): host ms
        # to its end, device ms by CUDA events, Python collective calls
        graphed = gba.replayed_global_solve(intr, GBA_ROUNDS, GBA_PCG,
                                            False, 1.0, group, ls)
        mine = (out.cam_q, out.cam_t, out.mp_pos, costs)
        calls = []
        g0 = torch.cuda.Event(enable_timing=True)
        g1 = torch.cuda.Event(enable_timing=True)
        for _ in range(3):
            group.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g0.record()
            g_out, g_costs = graphed(shard)
            g1.record()
            torch.cuda.synchronize()
            calls.append(dict(
                ms=(time.perf_counter() - t0) * 1e3,
                event_ms=g0.elapsed_time(g1),
                collectives=group.collectives(),
                same=all(torch.equal(a, b) for a, b in zip(
                    (g_out.cam_q, g_out.cam_t, g_out.mp_pos, g_costs), mine))))
        g_kern, g_nccl, g_n = _kernel_split(lambda: graphed(shard))
        res[name] = dict(rows=_solve_rows(gba.gather_global_data(out, group),
                                          costs, stats),
                         counts=counts, trip_bytes=trip, host_ms=host_ms,
                         end_ms=end_ms, event_ms=start.elapsed_time(end),
                         kernel_ms=kern_ms, nccl_ms=nccl_ms, kernels=n_kern,
                         graphed=calls, graphed_kernels=(g_kern, g_nccl, g_n))

    # SLAM.run_global_ba(group=) on phase 7's map: eagerly
    # (run_global_ba_on_map(graph=False)), then the shell's call three
    # times from the same map
    from kbslam_torch.pipeline import clone_state
    from kbslam_torch.slam import run_global_ba_on_map

    slam = SLAM(config.SLAMConfig(), refs["K"], device=dev)
    slam.state = slam.state._replace(
        map=convert.map_to_torch(refs["map_before"], dev))
    saved = clone_state(slam.state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager_map, eager_costs = run_global_ba_on_map(
        saved.map, slam.intr, slam.config.ba, group=group, graph=False)
    eager_ms = (time.perf_counter() - t0) * 1e3
    runs = []
    for _ in range(3):
        slam.state = saved
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_costs = slam.run_global_ba(group=group)
        m = slam.state.map
        runs.append(dict(ms=(time.perf_counter() - t0) * 1e3, same=(
            run_costs == eager_costs and all(
                torch.equal(getattr(m, f), getattr(eager_map, f))
                for f in ("kf_q", "kf_t", "mp_pos")))))
    res["run"] = dict(costs=run_costs, ms=runs[0]["ms"], eager_ms=eager_ms,
                      calls=runs, map=convert.map_to_numpy(slam.state.map))
    return res


def _dist_streams(group, frames_dir, K, refs) -> dict:
    """(22b, one rank) Config 4's 8 streams, this rank's block of them:
    the immediate step over the 33 frames and the deferred scan from frame
    0's warm start, as one batched program (held to phase 19's tracking
    and deferred gates, each stream's digest compared with phase 19's
    batched run) and one graph per stream (each stream's digest equal to
    phase 19's per-stream run), with the pace and the describe launches
    of this rank."""
    from kbslam_torch import config
    from kbslam_torch.geom.camera import Intrinsics
    from kbslam_torch.ops import describe as describe_ops
    from kbslam_torch.parallel.multistream import (batched_init_state,
                                                   make_multistream_scan,
                                                   make_multistream_step,
                                                   make_perstream_scan,
                                                   make_perstream_step,
                                                   shard_streams)

    dev, S, T, K_apply = group.device, MS_STREAMS, MS_FRAMES, MS_K

    def frames(name):          # [S, T, ...] on disk -> this rank's [T, S/W, ...]
        whole = torch.from_numpy(np.load(os.path.join(frames_dir, name),
                                          mmap_mode="c"))
        return shard_streams(whole, group).movedim(0, 1).contiguous() \
            .pin_memory()

    rgb, dep = frames("rgb.npy"), frames("dep.npy")
    first, n = group.rank * (S // group.world), S // group.world
    gt = refs["gt"][first:first + n]
    cfg, intr = config.SLAMConfig(), Intrinsics.from_matrix(K)
    group.reset_counts()
    out = dict(streams=list(range(first, first + n)), bad=[], launches={})
    for kind, make_step, make_scan in (
            ("batched", make_multistream_step, make_multistream_scan),
            ("perstream", make_perstream_step, make_perstream_scan)):
        describe_ops.reset_launches()
        step = make_step(cfg, intr, S, group=group)
        outs, final, warm, ms_step, _, _ = _timed_steps(
            step, shard_streams(batched_init_state(cfg, S, dev), group), rgb,
            dep)
        scan = make_scan(cfg, intr, S, apply_every=K_apply, group=group)
        _timed_scan(scan, warm, rgb[1:], dep[1:])          # the captures
        st_d, ninl, ms_frame_d = _timed_scan(scan, warm, rgb[1:], dep[1:])
        inl_min, kfs, ate = _tracking_gates(outs, final, gt, f"{kind} rank "
                                            f"{group.rank}")
        _deferred_gates(st_d.map.num_kf.cpu().numpy(), kfs,
                        st_d.map.num_mp.cpu().numpy(), ninl.cpu().numpy(),
                        torch.stack([o.num_inliers for o in outs[1:]]).cpu()
                        .numpy(), f"{kind} rank {group.rank}")
        immediate = _stream_digests(outs, final, first)
        deferred = _stream_digests([(ninl.movedim(1, 0),)], st_d, first)
        if kind == "batched":
            n_step = _replay_profile(_graph_of(step.program))[3]
            n_block = _replay_profile(_graph_of(scan.program))[3]
            replays, per = (step.program.replays, scan.program.replays), 1
        else:
            n_step = _replay_profile(step.streams._graphs[0])[3]
            n_block = _replay_profile(scan.streams._graphs[0])[3]
            replays, per = (step.streams.replays, scan.streams.replays), n
        if (n_step, n_block) != (1, K_apply):
            raise AssertionError(f"{kind} describe kernels per graph: step "
                                 f"{n_step}, block {n_block} (expected 1, "
                                 f"{K_apply})")
        differ = [(i, what) for what, mine, ref in
                  (("immediate", immediate, refs[f"{kind}_immediate"]),
                   ("deferred", deferred, refs[f"{kind}_deferred"]))
                  for i, h in mine if dict(ref)[i] != h]
        if kind == "perstream":
            out["bad"] = differ
        out[kind] = dict(
            ms_step=ms_step, ms_frame_deferred=ms_frame_d, differ=differ,
            inl_min=inl_min, ate=ate, eager=describe_ops.launches,
            replays=replays,
            launches=(describe_ops.launches + replays[0] * per * n_step
                      + replays[1] * per * n_block))
        del step, scan, outs, final, warm, st_d
    out["collectives"] = group.collectives()
    return out


def _dist_fusion(group, kf) -> dict:
    """(22c, one rank) The keyframes fused into this rank's slab of a
    512^3 volume: device ms per keyframe, peak memory, collectives; then
    the gathered volume against the unsharded ``integrate`` on this
    card."""
    import dataclasses

    from kbslam_torch import config
    from kbslam_torch.geom.camera import Intrinsics
    from kbslam_torch.mapping import dense

    dev = group.device
    base = config.SLAMConfig()
    dcfg = dataclasses.replace(base.dense, dims=DIST_DIMS,
                               voxel_size=DIST_VOXEL_M, origin=DIST_ORIGIN)
    intr, scale = Intrinsics.from_matrix(kf["K"]), base.map.depth_scale
    frames = [(torch.from_numpy(d).to(dev), torch.from_numpy(q).to(dev),
               torch.from_numpy(t).to(dev))
              for d, q, t in zip(kf["depth"], kf["q"], kf["t"])]
    fuse = dense.make_sharded_integrate(dcfg, intr, group, scale)

    def fused(slab):
        for d, q, t in frames:
            slab = fuse(slab, d, q, t)
        return slab

    fused(dense.shard_tsdf(dense.empty_tsdf(dcfg, dev), group))   # warm-up
    slab = dense.shard_tsdf(dense.empty_tsdf(dcfg, dev), group)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    group.reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    slab = fused(slab)
    end.record()
    torch.cuda.synchronize()
    collectives = group.collectives()
    ms = start.elapsed_time(end) / len(frames)
    peak_gb = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
    slab_shape = tuple(slab.tsdf.shape)
    whole = dense.gather_tsdf(slab, group)
    del slab
    ref = dense.empty_tsdf(dcfg, dev)
    one = dense.make_integrate(dcfg, intr, scale)
    for d, q, t in frames:
        ref = one(ref, d, q, t)
    equal = (torch.equal(whole.tsdf, ref.tsdf)
             and torch.equal(whole.weight, ref.weight))
    return dict(slab=slab_shape, collectives=collectives, ms=ms,
                peak_gb=peak_gb, equal=equal,
                observed=int((whole.weight > 0).sum()))


def _distributed_rank(group, frames_dir, refs):
    """(22) What every rank of the group runs; returns host data."""
    from kbslam_torch.ops import _build

    _build.build()      # the parent built it: this loads the cached library
    out = dict(rank=group.rank, world=group.world,
               card=torch.cuda.get_device_name(group.device))
    out["global_ba"] = _dist_global_ba(group, refs["gba"])
    out["streams"] = _dist_streams(group, frames_dir, refs["streams"]["K"],
                                   refs["streams"])
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    out["fusion"] = _dist_fusion(group, refs["fusion"])
    assert_no_jax()
    return out


def _same_rows(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k], b[k]) for k in b)


def distributed_phase(dev, smi, slam7, seq, gba_refs, stream_refs) -> tuple:
    """(22) The multi-device paths over one NCCL rank per card of this
    machine (``parallel.dist.spawn``): config 5 camera- and landmark-
    sharded against phase 18's eager solve, ``SLAM.run_global_ba(group=)``
    against phase 18's, config 4's streams sharded against phase 19's
    digests, and a 512^3 volume fused in slabs against the unsharded
    ``integrate``. Returns the describe launches of the ranks
    ((single-stream, batched))."""
    import tempfile

    from kbslam_torch.parallel import dist

    world = torch.cuda.device_count()
    kf_frames = [d["frame"] for d in slam7.diagnostics if d["added_kf"]]
    qt = [_pose_qt(slam7.frame_poses[f]) for f in kf_frames]
    refs = dict(
        gba=dict(K=seq.K, map_before=gba_refs["map_before"]),
        streams=dict(K=stream_refs["K"], gt=stream_refs["gt"],
                     batched_immediate=stream_refs["immediate"],
                     batched_deferred=stream_refs["deferred"],
                     perstream_immediate=stream_refs["perstream_immediate"],
                     perstream_deferred=stream_refs["perstream_deferred"]),
        fusion=dict(K=seq.K, depth=[seq.depth[f].astype(np.int32)
                                    for f in kf_frames],
                    q=[q for q, _ in qt], t=[t for _, t in qt]))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as frames_dir:
        for name, x in (("rgb.npy", stream_refs["rgb"]),
                        ("dep.npy", stream_refs["dep"])):
            np.save(os.path.join(frames_dir, name),
                    x.movedim(1, 0).contiguous().numpy())
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        runs = dist.spawn(_distributed_rank, world, "cuda",
                          (frames_dir, refs), timeout_s=DIST_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    cards = sorted({r["card"] for r in runs})

    # (a) config 5 against phase 18's eager solve on one card
    one = gba_refs["eager"]
    c1 = one["costs"].numpy()
    lines = []
    for name in ("camera", "landmark"):
        r = runs[0]["global_ba"][name]
        per_rank = [x["global_ba"][name] for x in runs]
        rows = r["rows"]
        c = rows["costs"].numpy()
        pcg, rpcg = rows["pcg_iters"].numpy(), one["pcg_iters"].numpy()
        rel = np.abs(c - c1) / np.abs(c1)
        if world == 1 and not _same_rows(rows, one):
            raise AssertionError(f"{name}-sharded solve at world 1 != phase "
                                 "18's eager solve")
        if not (torch.equal(rows["accepted"], one["accepted"])
                and torch.equal(rows["retries"], one["retries"])
                and (np.abs(pcg - rpcg) <= 1).all() and rel[1] <= 1e-3
                and np.isfinite(c).all() and (np.diff(c) <= 0).all()
                and c[-1] < 1e-2 * c[0]):
            raise AssertionError(
                f"{name}-sharded solve against one card: costs {c} vs {c1}, "
                f"accepted {rows['accepted'].tolist()} vs "
                f"{one['accepted'].tolist()}, retries "
                f"{rows['retries'].tolist()} vs {one['retries'].tolist()}, "
                f"PCG {pcg} vs {rpcg}")
        for other in runs[1:]:
            if not torch.equal(other["global_ba"][name]["rows"]["mp_pos"],
                               rows["mp_pos"]):
                raise AssertionError(f"{name}-sharded: the ranks' landmarks "
                                     "differ")
        lines.append(
            f"{name}-sharded: cost {[round(float(x), 3) for x in c]}, "
            f"relative gap to one card per round "
            f"{[float(f'{x:.2e}') for x in rel[1:]]}, PCG trips "
            f"{pcg.tolist()} (one card {rpcg.tolist()}); per solve and rank "
            f"host {[round(x['host_ms'], 1) for x in per_rank]} ms to "
            f"enqueue, {[round(x['end_ms'], 1) for x in per_rank]} ms to its "
            f"end, device {[round(x['event_ms'], 2) for x in per_rank]} ms by "
            f"CUDA events around the eager solve, "
            f"{[round(x['kernel_ms'], 2) for x in per_rank]} ms summed time "
            f"of the compute kernels and "
            f"{[round(x['nccl_ms'], 2) for x in per_rank]} ms of the NCCL "
            f"kernels (waits for the other ranks included), "
            f"{[x['kernels'] for x in per_rank]} kernels (torch.profiler); "
            f"rank 0's collectives per solve "
            f"(calls, bytes) {r['counts']}, {_nbytes(r['counts'])} bytes, "
            f"{r['trip_bytes']:.0f} bytes per PCG trip")
    run = runs[0]["global_ba"]["run"]
    after, before = gba_refs["map_after"], gba_refs["map_before"]
    g = gba_refs["gauge_slot"]
    rc, rc1 = np.asarray(run["costs"]), np.asarray(gba_refs["run_costs"])
    run_gap = np.abs(rc - rc1) / np.abs(rc1)
    if world == 1 and not (
            list(run["costs"]) == list(gba_refs["run_costs"])
            and all(np.array_equal(getattr(run["map"], k), getattr(after, k))
                    for k in ("kf_q", "kf_t", "mp_pos"))):
        raise AssertionError("SLAM.run_global_ba(group=) at world 1 != "
                             "phase 18's")
    if not (np.isfinite(rc).all() and (np.diff(rc) <= 0).all()
            and (run_gap <= 1e-3).all()
            and np.array_equal(run["map"].kf_q[g], before.kf_q[g])
            and np.array_equal(run["map"].kf_t[g], before.kf_t[g])):
        raise AssertionError(f"SLAM.run_global_ba(group=): costs {rc} vs "
                             f"phase 18's {rc1}, or the gauge moved")
    graphed = []
    for name in ("camera", "landmark"):
        per_rank = [x["global_ba"][name]["graphed"] for x in runs]
        if not all(c["same"] for calls in per_rank for c in calls):
            raise AssertionError(f"the captured {name}-sharded solve != the "
                                 "eager sharded solve")
        if any(calls[2]["collectives"] for calls in per_rank):
            raise AssertionError(f"the {name}-sharded replay made collective "
                                 "calls from the host")
        kern = [x["global_ba"][name]["graphed_kernels"] for x in runs]
        graphed.append(
            f"{name}-sharded captured with its collectives and replayed, "
            f"bit-equal to the eager sharded solve on every rank: host ms "
            f"to the end of the first call (eager) "
            f"{[round(c[0]['ms'], 1) for c in per_rank]}, of the second "
            f"(capture, replay) {[round(c[1]['ms'], 1) for c in per_rank]}, "
            f"of the third (a replay) "
            f"{[round(c[2]['ms'], 1) for c in per_rank]}, device "
            f"{[round(c[2]['event_ms'], 2) for c in per_rank]} ms by CUDA "
            f"events, {[round(k[0], 2) for k in kern]} ms of compute kernels "
            f"and {[round(k[1], 2) for k in kern]} ms of NCCL kernels in "
            f"{[k[2] for k in kern]} kernels (torch.profiler), 0 collective "
            f"calls from the host in a replay")
    run_calls = [x["global_ba"]["run"] for x in runs]
    if not all(c["same"] for r in run_calls for c in r["calls"]):
        raise AssertionError("SLAM.run_global_ba(group=) != the eager "
                             "sharded solve")
    graphed.append(
        f"SLAM.run_global_ba(group=) per rank: eager "
        f"{[round(r['eager_ms'], 1) for r in run_calls]} ms, first call "
        f"{[round(r['calls'][0]['ms'], 1) for r in run_calls]} ms (eager), "
        f"second {[round(r['calls'][1]['ms'], 1) for r in run_calls]} ms "
        f"(capture, replay), third "
        f"{[round(r['calls'][2]['ms'], 1) for r in run_calls]} ms (a "
        f"replay), all bit-equal to the eager sharded run")
    print(f"[distributed] world {world} ({', '.join(cards)}; one NCCL rank "
          f"per card through parallel.dist.spawn, {spawn_s:.1f} s for the "
          f"ranks' whole run, frames written in {write_s:.1f} s); config 5 "
          f"({GBA_CAMS} cameras, {GBA_PTS} landmarks, {GBA_ROUNDS} rounds, "
          f"PCG cap {GBA_PCG}, tol {GBA_TOL}), "
          f"{GBA_CAMS // world} cameras per rank, eagerly: "
          + "; ".join(lines)
          + ("; both bit-equal to phase 18's eager solve" if world == 1
             else "; phase 18's gates hold against its one-card solve")
          + f"; SLAM.run_global_ba(group=) on phase 7's map: cost "
          f"{[round(x, 3) for x in run['costs']]}, "
          + ("bit-equal to phase 18's" if world == 1 else
             f"within {run_gap.max():.1e} of phase 18's per round")
          + f", the gauge keyframe bit-unchanged, {run['ms']:.1f} ms; "
          + "; ".join(graphed) + f"; {smi}", flush=True)

    # (b) config 4 sharded against phase 19's digests
    st = [r["streams"] for r in runs]
    bad = [b for s in st for b in s["bad"]]
    if bad or any(s["collectives"] for s in st):
        raise AssertionError(f"sharded per-stream graphs != phase 19 (stream, "
                             f"run): {bad}; collectives "
                             f"{[s['collectives'] for s in st]}")
    launches = tuple(sum(s[k]["launches"] for s in st)
                     for k in ("perstream", "batched"))

    def pace(kind):
        fps = sum(len(s["streams"]) * 1e3 / s[kind]["ms_step"] for s in st)
        fps_d = sum(len(s["streams"]) * 1e3 / s[kind]["ms_frame_deferred"]
                    for s in st)
        return (f"immediate {fps:.1f} frames/s together (ms per step per "
                f"rank {[round(s[kind]['ms_step'], 2) for s in st]}, CUDA "
                f"events, steps 2-{MS_FRAMES}), deferred {fps_d:.1f} frames/s"
                f" (ms per frame "
                f"{[round(s[kind]['ms_frame_deferred'], 2) for s in st]}); "
                f"describe launches {sum(s[kind]['launches'] for s in st)} "
                f"({[s[kind]['eager'] for s in st]} eager, replays (step, "
                f"block) {[s[kind]['replays'] for s in st]})")

    differ = [d for s in st for d in s["batched"]["differ"]]
    print(f"[distributed] config 4: {MS_STREAMS} streams of 640x480, "
          f"{MS_FRAMES} frames, {MS_STREAMS // world} per rank "
          f"({[s['streams'] for s in st]}); 0 collectives while tracking; "
          f"batched, one graph per step and per block on each rank: every "
          f"stream tracked with >= {MIN_INLIERS} inliers after frame 0 (min "
          f"{min(s['batched']['inl_min'] for s in st)}), ATE per stream "
          f"{[round(a * 1e3, 2) for s in st for a in s['batched']['ate']]} "
          f"mm, the deferred gates hold; against phase 19's batched run "
          + ("every stream bit-equal (SHA-256 of every row), immediate and "
             "deferred" if not differ else
             f"(stream, run) differing: {differ}")
          + f"; {pace('batched')}; per-stream graphs: every stream's outputs "
          f"and state bit-equal to phase 19's per-stream run, immediate and "
          f"deferred; {pace('perstream')}; {smi}", flush=True)

    # (c) the 512^3 volume in slabs
    fu = [r["fusion"] for r in runs]
    if not all(f["equal"] and f["collectives"] == 0 for f in fu):
        raise AssertionError(f"slab fusion: equal {[f['equal'] for f in fu]}"
                             f", collectives {[f['collectives'] for f in fu]}")
    V = int(np.prod(DIST_DIMS))
    print(f"[distributed] fusion: {len(kf_frames)} keyframes of phase 7's run "
          f"(frames {kf_frames}) into a {DIST_DIMS} volume of "
          f"{DIST_VOXEL_M} m voxels ({V * 8 / 1e9:.3f} GB of tsdf and weight),"
          f" slabs of {fu[0]['slab']} per rank: gathered, bit-equal to the "
          f"unsharded integrate on the card ({fu[0]['observed']} voxels "
          f"observed); 0 collectives while fusing; device "
          f"{[round(f['ms'], 3) for f in fu]} ms per keyframe per rank (CUDA "
          f"events over the {len(kf_frames)} eager calls), peak "
          f"{[round(f['peak_gb'], 3) for f in fu]} GB per card above the "
          f"slab; {smi}", flush=True)
    return launches


# 23. the dense reference solver and the reference's last tracking gates
DIST = (0.22, -0.4, 0.0, 0.0, 0.0)   # tests/test_pipeline.py:149
# the cv2/scipy oracle at 640x480 (kbslam/eval/reference_slam.py), run on
# the CPU by tests/test_torch_parity_vs_opencv.py: refined ATE and
# keyframe ATE, in metres. The oracle is not copied into the port (it
# runs in the CPU tests, imported from kbslam/), so its bound is not
# held here.
ORACLE_640_M = (9.54e-3, 7.90e-3)


def dense_solver_check(dev, smi, slam):
    """(23a) ``ba/lm.py``'s dense solve of phase 6's full-width window on
    the card: against the card's compact solve with tests/test_ba.py:
    175-191's bounds, and against the same dense solve on the CPU with
    phase 6's; the solve under sync debug mode "error"; device ms as a
    replayed graph, launches, host ms and peak memory.

    Against the compact solve both are held after 3 and after 20 LM
    trips. Against the CPU the plane window's near-null valley
    (``ba_phase``) holds the iterates after 3 trips and the 20-trip solve
    by cost, with its pose gap printed."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from kbslam_torch.ba.compact import compact_problem
    from kbslam_torch.ba.compact_lm import solve_window_compact
    from kbslam_torch.ba.lm import solve_window
    from kbslam_torch.ba.problem import build_problem
    from kbslam_torch.mapping.state import MapState

    m, cfg, intr = slam.state.map, slam.config.ba, slam.intr
    cfg3 = dataclasses.replace(cfg, max_iterations=3)

    def dense(mp, c):
        prob = build_problem(mp, intr, c)
        return prob, solve_window(prob, mp.mp_pos, intr, c)

    dense(m, cfg)                    # warm-up: handles, allocator
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        prob, sol = dense(m, cfg)
        host_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        dense(m, cfg)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in kernels) / 1e3
    graph_ms = cuda_ms(lambda: dense(m, cfg), iters=1, replays=5)

    # the compact solve of the same window; its layout holds every active
    # observation and landmark (a cut layout would solve another problem)
    W, F = prob.mp_id.shape
    n_obs = int(prob.active.sum())
    n_lm = int((prob.inlier_obs > 0).sum())
    O = cfg.compact_obs if n_obs <= cfg.compact_obs else W * F
    L = cfg.compact_landmarks if n_lm <= cfg.compact_landmarks else W * F

    cp = compact_problem(prob, m.mp_pos, O, L)
    lids = cp.uniq_global.cpu().numpy()
    lv = cp.l_valid.cpu().numpy()

    def against_compact(d, c):
        """tests/test_ba.py:175-191's gaps: (initial cost, final cost,
        max |cam_t|, max |cam_q|, max landmark) of dense and compact."""
        comp = solve_window_compact(prob, cp, intr, c)
        return (float(d.initial_cost), float(comp.initial_cost),
                float(d.final_cost), float(comp.final_cost),
                float((comp.cam_t - d.cam_t).abs().max()),
                float((comp.cam_q - d.cam_q).abs().max()),
                float(np.abs(comp.Xc.cpu().numpy()[lv]
                             - d.mp_pos.cpu().numpy()[lids[lv]]).max()))

    _, d3 = dense(m, cfg3)
    vs_compact = [against_compact(d3, cfg3), against_compact(sol, cfg)]
    ok_c = all(np.isclose(i_d, i_c, rtol=1e-4)
               and np.isclose(f_d, f_c, rtol=0.05, atol=1e-4)
               and dt <= 1e-3 and dq <= 1e-3 and dX <= 5e-3
               for i_d, i_c, f_d, f_c, dt, dq, dX in vs_compact)

    # the same dense solves on the CPU
    cpu_map = MapState(*(t.cpu() for t in m))
    _, r3 = dense(cpu_map, cfg3)
    _, r20 = dense(cpu_map, cfg)
    gap3 = _gap(d3.cam_t, d3.cam_q, r3.cam_t, r3.cam_q)
    gap20 = _gap(sol.cam_t, sol.cam_q, r20.cam_t, r20.cam_q)
    init, final, cpu_final = (float(sol.initial_cost), float(sol.final_cost),
                              float(r20.final_cost))
    finite = all(bool(torch.isfinite(x).all())
                 for x in (sol.cam_q, sol.cam_t, sol.mp_pos))
    ok_cpu = (finite and gap3[0] <= 1e-3 and gap3[1] <= 0.05
              and final <= init
              and abs(final - cpu_final) <= 1e-3 * abs(cpu_final))
    if not (ok_c and ok_cpu):
        raise AssertionError(
            f"dense solve on the card: against compact after 3 and 20 trips "
            f"(costs, poses, landmarks) {vs_compact}; against the CPU after "
            f"3 trips {gap3}, cost {init} -> {final} (CPU {cpu_final}), "
            f"finite {finite}")
    u_mb = m.mp_pos.shape[0] * W * 18 * 4 / 1e6
    print(f"[gates] dense reference solve (ba/lm.py) of phase 6's window "
          f"({W} keyframes, {n_obs} active observations, {n_lm} landmarks "
          f"of {m.mp_pos.shape[0]}; U [{m.mp_pos.shape[0]}, {W}, 6, 3] "
          f"{u_mb:.1f} MB): cost {init:.3f} -> {final:.3f} (CPU "
          f"{cpu_final:.3f}), {int(sol.iterations)} iterations; against the "
          f"card's compact solve (layout O={O}, L={L}) after 3 and 20 trips "
          f"(initial and final costs dense/compact, max |cam_t| m, max "
          f"|cam_q|, max landmark m): "
          f"{[tuple(float(f'{x:.6g}') for x in r) for r in vs_compact]}; "
          f"against "
          f"the CPU after 3 trips {gap3[0]:.2e} m and {gap3[1]:.2e} deg, "
          f"after 20 {gap20[0]:.2e} m and {gap20[1]:.2e} deg (printed); 0 "
          f"host syncs (sync debug mode 'error'); per solve (with "
          f"build_problem): device {graph_ms:.2f} ms (CUDA graph replay), "
          f"kernel time {busy_ms:.2f} ms and {len(kernels)} kernel launches "
          f"(torch.profiler), host {host_ms:.2f} ms, peak "
          f"{peak_gb:.4f} GB above the map; {smi}", flush=True)


def distorted_sequence(seq):
    """tests/test_pipeline.py:150-171's warp of ``seq`` through the
    Brown-Conrady model: I_dist(u_d) = I_rect(undistort(u_d)), with the
    port's ``undistort_points`` (equal bit for bit to the reference's op
    by op, tests/test_torch_gates.py)."""
    from scipy.ndimage import map_coordinates

    from kbslam_torch.geom.camera import Intrinsics, undistort_points

    h, w = seq.depth.shape[1:]
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
    src = undistort_points(Intrinsics.from_matrix(seq.K, dist=DIST),
                           torch.from_numpy(np.stack([gx.ravel(), gy.ravel()],
                                                     1))).numpy()
    coords = np.stack([src[:, 1].reshape(h, w), src[:, 0].reshape(h, w)])

    def warp(img, order):
        if img.ndim == 3:
            return np.stack([map_coordinates(img[..., c].astype(np.float32),
                                             coords, order=order,
                                             mode="nearest")
                             for c in range(img.shape[2])], -1).astype(img.dtype)
        return map_coordinates(img.astype(np.float32), coords, order=order,
                               mode="nearest").astype(img.dtype)

    return seq._replace(rgb=np.stack([warp(f, 1) for f in seq.rgb]),
                        depth=np.stack([warp(f, 0) for f in seq.depth]))


def rim_gate_check(dev):
    """tests/test_pipeline.py::test_rim_gate_range_aware_threshold's body
    on the card's ``extract_frame``; returns the printed counts."""
    import dataclasses

    from scipy.ndimage import grey_dilation, grey_erosion

    from kbslam_torch import config
    from kbslam_torch.geom.camera import Intrinsics
    from kbslam_torch.pipeline import extract_frame

    H, W = 240, 320
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
    clean = np.full((H, W), 6.0, np.float32)
    clean[90:150, 120:200] = 1.0
    noisy = clean + rng.normal(0.0, 1.0, clean.shape).astype(
        np.float32) * 0.003 * clean**2
    depth = np.clip(noisy * 1000.0, 1, 65535).astype(np.uint16)
    true_spread = grey_dilation(clean, 3) - grey_erosion(clean, 3)
    intr = Intrinsics.from_matrix(np.array(
        [[260.0, 0, (W - 1) / 2], [0, 260.0, (H - 1) / 2], [0, 0, 1]]))
    cfg = _cfg240(config)

    def gate_stats(rel):
        c = cfg.replace(map=dataclasses.replace(cfg.map,
                                                depth_edge_rel_per_m2=rel))
        feats, depth_kp = extract_frame(
            torch.from_numpy(rgb).to(dev),
            torch.from_numpy(depth.astype(np.int32)).to(dev), None, intr, c)
        xy = np.round(feats.xy.cpu().numpy()).astype(int)
        v = (feats.valid.cpu().numpy() & (xy[:, 0] >= 1) & (xy[:, 0] < W - 1)
             & (xy[:, 1] >= 1) & (xy[:, 1] < H - 1))
        ts = true_spread[xy[v, 1], xy[v, 0]]
        kept = depth_kp.cpu().numpy()[v] > 0
        far = (ts < 0.1) & (clean[xy[v, 1], xy[v, 0]] > 3.0)
        return kept, far, ts > 1.0

    kept_abs, far_abs, rim_abs = gate_stats(0.0)
    kept_rel, far_rel, rim_rel = gate_stats(0.03)
    got = dict(far=int(far_abs.sum()), rim=int(rim_abs.sum()),
               far_kept_abs=float(kept_abs[far_abs].mean()),
               far_kept_rel=float(kept_rel[far_rel].mean()),
               rim_kept_abs=float(kept_abs[rim_abs].mean()),
               rim_kept_rel=float(kept_rel[rim_rel].mean()))
    if not (got["far"] > 50 and got["rim"] > 3 and got["far_kept_abs"] < 0.10
            and got["far_kept_rel"] > 0.70 and got["rim_kept_abs"] < 0.05
            and got["rim_kept_rel"] < 0.05):
        raise AssertionError(f"rim gate on the card: {got}")
    return got


def tracking_gates_check(dev, smi) -> int:
    """(23b) tests/test_pipeline.py's distortion, mask, rim and blank-frame
    gates on the card at their own sizes (240x320), through ``SLAM`` with
    BA off and the port's own draws, every assertion enforced (each held
    on the CPU on the port's own draws, tests/test_torch_gates.py).
    Returns the describe launches."""
    from kbslam_torch import config
    from kbslam_torch.eval import trajectory
    from kbslam_torch.io import synthetic
    from kbslam_torch.slam import SLAM

    cfg = _cfg240(config)
    launches = 0

    def run(seq, masks=None, **kw):
        nonlocal launches
        reset_launch_counts()
        slam = SLAM(cfg, seq.K, ba_mode="disabled", device=dev,
                    use_mask=masks is not None, **kw)
        track(slam, seq, masks)
        est = np.stack(slam.frame_poses)
        launches += check_shell_launches("tracking gates", len(seq.rgb))
        return (trajectory.ate_rmse(est[:, :3, 3], seq.poses[:, :3, 3]),
                slam.diagnostics)

    t0 = time.perf_counter()
    seq_d = distorted_sequence(synthetic.render_sequence(
        num_frames=20, height=240, width=320))
    ate_d, diags_d = run(seq_d, dist=DIST)
    ate_no, _ = run(seq_d)                     # coefficients ignored
    fails = sum(not d["success"] for d in diags_d[1:])
    if not (fails <= 3 and ate_d < 0.040 and ate_d < 0.6 * ate_no):
        raise AssertionError(f"distorted rendering: {fails} failed, ATE "
                             f"{ate_d} m, ignored {ate_no} m")

    seq_m = synthetic.render_sequence(num_frames=20, height=240, width=320,
                                      moving_box=True)
    ate_on, diags_m = run(seq_m, masks=seq_m.mask)
    ate_off, _ = run(seq_m, masks=np.full_like(seq_m.mask, 255))
    tracked = all(d["success"] for d in diags_m[1:])
    if not (tracked and ate_on < 0.06 and ate_on < ate_off
            and ate_off > 2.0 * ate_on):
        raise AssertionError(f"mask gate: all tracked {tracked}, ATE on "
                             f"{ate_on} m, off {ate_off} m")

    rim = rim_gate_check(dev)

    # blank frames hold the keyframe counter (tests/test_pipeline.py:113)
    seq4 = synthetic.render_sequence(num_frames=4, height=240, width=320)
    slam = SLAM(cfg, seq4.K, ba_mode="disabled", use_mask=False, device=dev)
    blank = (np.zeros((240, 320, 3), np.uint8), np.zeros((240, 320), np.uint16))
    counters, matches = [], []
    for rgb, depth in ([(seq4.rgb[0], seq4.depth[0]),
                        (seq4.rgb[1], seq4.depth[1])] + [blank] * 3
                       + [(seq4.rgb[2], seq4.depth[2])]):
        reset_launch_counts()
        d = slam.process(rgb, depth)
        launches += check_shell_launches("blank frames", 1)
        counters.append(int(slam.state.frames_since_kf))
        matches.append(d["num_matches"])
    base = counters[1]
    if not (matches[1] >= 4 and all(n < 4 for n in matches[2:5])
            and counters[4] == base and counters[5] in (0, base + 1)):
        raise AssertionError(f"blank frames: counters {counters}, matches "
                             f"{matches}")
    print(f"[gates] tests/test_pipeline.py's gates at 240x320, own draws: "
          f"distorted rendering (k1 0.22, k2 -0.4) {fails} failed frames, "
          f"ATE {ate_d * 1e3:.2f} mm with the coefficients, "
          f"{ate_no * 1e3:.2f} mm without (ratio {ate_d / ate_no:.3f}, "
          f"bounds 40 mm and 0.6); static mask: all tracked, ATE on "
          f"{ate_on * 1e3:.2f} mm, off {ate_off * 1e3:.2f} mm (ratio "
          f"{ate_off / ate_on:.2f}, bounds 60 mm and 2); rim gate {rim}; "
          f"blank frames: counters {counters}, matches {matches}; every "
          f"gate enforced; describe launches {launches} (one per frame); "
          f"{time.perf_counter() - t0:.1f} s; {smi}", flush=True)
    return launches


def full_system_640_check(dev, smi) -> int:
    """(23c) tests/test_parity_vs_opencv.py:106-120's sequence through
    ``SLAM`` at ``SLAMConfig()`` with BA after each keyframe: refined ATE
    under 8 mm and keyframe ATE within the CPU oracle's + 1 mm, enforced;
    the bound against the oracle itself stays in the CPU test. Returns the
    describe launches."""
    import importlib.util

    from kbslam_torch import config
    from kbslam_torch.eval import trajectory
    from kbslam_torch.io import synthetic
    from kbslam_torch.slam import SLAM

    seq = synthetic.render_sequence(num_frames=30, height=480, width=640,
                                    fx=525.0, seed=0)
    reset_launch_counts()
    t0 = time.perf_counter()
    slam = track(SLAM(config.SLAMConfig(), seq.K, use_mask=False,
                      device=dev), seq)
    wall = time.perf_counter() - t0
    launches = check_shell_launches("640x480 full system", 30)
    gt = seq.poses[:, :3, 3]
    ate = trajectory.ate_rmse(np.stack(slam.frame_poses)[:, :3, 3], gt)
    refined = trajectory.ate_rmse(slam.refined_trajectory()[:, :3, 3], gt)
    kf_frames = [d["frame"] for d in slam.diagnostics if d["added_kf"]]
    kf = trajectory.ate_rmse(slam.keyframe_positions(),
                             seq.poses[kf_frames][:, :3, 3])
    oracle, oracle_kf = ORACLE_640_M
    has_cv2 = importlib.util.find_spec("cv2") is not None
    if not (np.isfinite(refined) and refined < 8e-3
            and kf <= oracle_kf + 1e-3):
        raise AssertionError(f"640x480 full system: refined {refined} m, "
                             f"keyframes {kf} m, {launches} describe launches")
    print(f"[gates] 640x480 full system (tests/test_parity_vs_opencv.py:106, "
          f"30 frames, SLAMConfig(), BA on keyframe, own draws): refined ATE "
          f"{refined * 1e3:.2f} mm (online {ate * 1e3:.2f}), keyframe ATE "
          f"{kf * 1e3:.2f} mm over {len(kf_frames)} keyframes, "
          f"{len(slam.ba_stats)} solves; bounds refined < 8 mm and keyframes "
          f"<= {oracle_kf * 1e3:.2f} + 1 mm enforced; the CPU oracle's "
          f"{oracle * 1e3:.2f} mm refined for reference only (cv2 "
          f"importable here: {has_cv2}); "
          f"{wall:.1f} s; describe launches {launches}; {smi}", flush=True)
    return launches


def gates_phase(dev, smi, window_slam) -> int:
    """(23) the dense reference solver on the card and the reference's
    last tracking gates; returns the describe launches."""
    t0 = time.perf_counter()
    dense_solver_check(dev, smi, window_slam)
    launches = tracking_gates_check(dev, smi)
    launches += full_system_640_check(dev, smi)
    print(f"[gates] phase 23 took {time.perf_counter() - t0:.1f} s; describe "
          f"launches {launches}", flush=True)
    return launches


def gates_alone(dev, smi, name) -> int:
    """``--only gates``: phase 23 on phase 6's window, after phases 1-2."""
    from kbslam_torch.io import synthetic

    seq = synthetic.render_sequence(num_frames=FRAMES, height=480, width=640)
    gates_phase(dev, smi, ba_window(dev, seq)[0])
    assert_no_jax()
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


def distributed_alone(dev, smi, name) -> int:
    """``--only distributed``: phase 22 after the phases it is held to
    (phase 5's sequence, 7, 18 and 19; phase 19 without phase 10's pace),
    for a run on several cards."""
    from kbslam_torch import config
    from kbslam_torch.io import synthetic
    from kbslam_torch.slam import SLAM

    seq = synthetic.render_sequence(num_frames=FRAMES, height=480, width=640)
    slam = track(SLAM(config.SLAMConfig(), seq.K, device=dev), seq)
    ate = check_ba_run(slam, seq)
    gba_refs = global_ba_phase(dev, smi, slam, seq, ate)
    _, stream_refs = multistream_phase(dev, smi, {"ms_frame": float("nan")})
    distributed_phase(dev, smi, slam, seq, gba_refs, stream_refs)
    assert_no_jax()
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


def chunked_alone(dev, smi, name) -> int:
    """``--only chunked``: phases 14-18 after phases 1-2, phase 18 on a map
    tracked as phase 7 tracks it (phase 10's pace and phase 7's ms are
    not measured here)."""
    from kbslam_torch import config
    from kbslam_torch.io import synthetic
    from kbslam_torch.slam import SLAM

    seq = synthetic.render_sequence(num_frames=FRAMES, height=480, width=640)
    nan = float("nan")
    pace = {"ms_frame": nan, "busy": nan, "slam_ba_ms": nan}
    reloc_phase(dev, smi)
    chunk_loop_phase(dev, smi, pace)
    dense_phase(dev, seq, smi, pace)
    submap_phase(dev, seq, smi, pace)
    slam = track(SLAM(config.SLAMConfig(), seq.K, device=dev), seq)
    global_ba_phase(dev, smi, slam, seq, check_ba_run(slam, seq))
    assert_no_jax()
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


def multistream_alone(dev, smi, name) -> int:
    """``--only multistream``: phase 4b and phase 19 after phases 1-2,
    with the kernels line of the batched describe launch."""
    fig = batched_describe_phase(dev, smi)
    (_, batched), _ = multistream_phase(dev, smi, {"ms_frame": float("nan")})
    assert_no_jax()
    print(json.dumps({"kernels": [dict(
        name="describe_keypoints (8 streams per launch)", route="cuda",
        source="kbslam_torch/csrc/describe.cu",
        replaces="kbslam/ops/pallas_patches.py:153", launches=batched,
        library_ms=None, **fig)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    modes = ("distributed", "gates", "shell", "multistream", "chunked")
    if argv and (len(argv) != 2 or argv[0] != "--only"
                 or argv[1] not in modes):
        print("usage: python3 chip_smoke.py [--only "
              + "|".join(modes) + "]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from kbslam_torch.device import pick_device
    from kbslam_torch.frontend import brief
    from kbslam_torch.io import synthetic
    from kbslam_torch.ops import _build
    from kbslam_torch.ops import describe as describe_ops
    from kbslam_torch.ops import patches as patch_ops

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
    if argv == ["--only", "gates"]:
        return gates_alone(dev, smi, name)
    if argv == ["--only", "shell"]:
        return shell_alone(dev, smi, name)
    if argv == ["--only", "multistream"]:
        return multistream_alone(dev, smi, name)
    if argv == ["--only", "chunked"]:
        return chunked_alone(dev, smi, name)
    if argv:
        return distributed_alone(dev, smi, name)

    # 3. the patch kernel against its plain twin and the one-call yardstick
    clock = [("3-4", time.perf_counter())]   # (phase, its start), in order
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
    batched_fig = batched_describe_phase(dev, smi)

    clock.append(("5-7", time.perf_counter()))
    # 5-7. the tracking slice, one full-width solve, the default path
    seq = synthetic.render_sequence(num_frames=FRAMES, height=480, width=640)
    slam5, launches = slice_phase(dev, seq, smi)
    slice_poses = np.stack(slam5.frame_poses[:FRAMES])
    del slam5
    window_slam = ba_phase(dev, seq, smi)
    slam, ate, ate_ref, phase7_ms, launches_ba = default_path_phase(
        dev, seq, smi)
    launches = {k: launches[k] + launches_ba[k] for k in launches}

    clock.append(("8", time.perf_counter()))
    # 8. asynchronous BA on a side stream
    async_phase(dev, seq, smi)

    clock.append(("9", time.perf_counter()))
    # 9. the hard NK=3 scene of tests/test_ba_in_loop.py
    nk3_phase(dev, smi)

    clock.append(("10-12", time.perf_counter()))
    # 10-12. the chunked streaming executor: one CUDA graph per chunk,
    # chunk-late async BA on a graphed solve, checkpoint and resume
    pace = {"slam_ba_ms": phase7_ms}
    chunked, chunk_launches = chunk_phase(dev, seq, smi, pace)
    launches["describe_keypoints"] += chunk_launches
    chunk_async_phase(dev, seq, smi)
    checkpoint_phase(dev, seq, chunked, smi)

    clock.append(("13-15", time.perf_counter()))
    # 13-15. loop closure, relocalization and culling
    loop_phase(dev, smi)
    launches["describe_keypoints"] += reloc_phase(dev, smi)
    chunk_loop_phase(dev, smi, pace)

    clock.append(("16", time.perf_counter()))
    # 16. the monolithic TSDF volume: integrate, raycast, the shells
    launches["describe_keypoints"] += dense_phase(dev, seq, smi, pace)

    clock.append(("17", time.perf_counter()))
    # 17. the submap atlas and dense ICP
    launches["describe_keypoints"] += submap_phase(dev, seq, smi, pace)

    clock.append(("18", time.perf_counter()))
    # 18. global BA at config 5, and on phase 7's map
    gba_refs = global_ba_phase(dev, smi, slam, seq, (ate, ate_ref))

    clock.append(("19", time.perf_counter()))
    # 19. multistream tracking at config 4
    (ms_single, ms_batched), stream_refs = multistream_phase(dev, smi, pace)
    launches["describe_keypoints"] += ms_single

    clock.append(("20", time.perf_counter()))
    # 20. tests/test_longrun.py on the card
    longrun_phase(dev, smi)

    clock.append(("21", time.perf_counter()))
    # 21. the ingress and egress through both CLI paths; the end-to-end
    # gates
    launches["describe_keypoints"] += io_phase(dev, seq, smi, pace,
                                               slice_poses)

    clock.append(("22", time.perf_counter()))
    # 22. the multi-device paths, one NCCL rank per card
    dist_single, dist_batched = distributed_phase(
        dev, smi, slam, seq, gba_refs, stream_refs)
    launches["describe_keypoints"] += dist_single

    clock.append(("23", time.perf_counter()))
    # 23. the dense reference solver; the reference's last tracking gates
    launches["describe_keypoints"] += gates_phase(dev, smi, window_slam)

    clock.append(("end", time.perf_counter()))
    assert_no_jax()
    print("[timing] host seconds per phase: " + ", ".join(
        f"{name} {end - start:.1f}" for (name, start), (_, end) in
        zip(clock[:-1], clock[1:])) + f"; phases 3-23 "
        f"{clock[-1][1] - clock[0][1]:.1f}", flush=True)

    print(json.dumps({"kernels": [
        {"name": "describe_keypoints", "route": "cuda",
         "source": "kbslam_torch/csrc/describe.cu",
         "replaces": "kbslam/ops/pallas_patches.py:153",
         "launches": launches["describe_keypoints"], "max_abs_err": max_err,
         "ms": d_ms, "plain_ms": d_plain, "bound_ms": d_bound,
         "bound_by": d_by, "library_ms": None},
        dict(name="describe_keypoints (8 streams per launch)", route="cuda",
             source="kbslam_torch/csrc/describe.cu",
             replaces="kbslam/ops/pallas_patches.py:153",
             launches=ms_batched + dist_batched, library_ms=None,
             **batched_fig),
        {"name": "extract_patches", "route": "cuda",
         "source": "kbslam_torch/csrc/patches.cu",
         "replaces": "kbslam/ops/pallas_patches.py:153",
         "launches": launches["extract_patches"], "max_abs_err": 0.0,
         "ms": p_ms, "plain_ms": p_plain, "bound_ms": p_bound,
         "bound_by": p_by, "library_ms": p_lib}] + [
        {"name": f"icp_fetch_kernel ({r[0]}, K = {r[1]})",
         "route": "cuda", "source": "kbslam_torch/csrc/icp.cu",
         "replaces": None, "launches_per_solve": r[5],
         "main_path_launches": pace["icp_main"][0], "kernel_ms": r[16],
         "ms": r[2], "plain_ms": r[3], "bound_ms": r[7] / 1e3,
         "bound_by": r[8], "library_ms": None} for r in pace["icp_rows"]] + [
        {"name": "icp_fetch_kernel (align_depth_to_atlas, K = 3, the dense "
                 "cell's 512^3 ring)",
         "route": "cuda", "source": "kbslam_torch/csrc/icp.cu",
         "replaces": None, "launches_per_solve": pace["icp_big"][3],
         "kernel_ms": pace["icp_big"][2], "ms": pace["icp_big"][0],
         "plain_ms": pace["icp_big"][1], "library_ms": None}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
