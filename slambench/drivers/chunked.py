"""Driver ``chunked``: a recorded sequence replayed offline through
``streaming.ChunkedStream``, closed loop (the CLI's ``--chunk C --ba
async``).

Frames are fed as fast as ``feed`` takes them; every C-th frame
dispatches a chunk (one replay of the chunk graph) and results come back
up to 2C frames late. The window ends at the first chunk boundary after
``--seconds``; the rate is the results that came back in the window over
its length. ``flush`` after the window drains the rest, for the check.

The check follows the stream from its own state. Before the feed that
dispatches a sampled chunk, and before the one that dispatches the next,
the driver copies the state on the device; after each feed it notes
whether a local-BA solve was dispatched (a new solve in flight) or
merged (a new record in ``ba_stats``), and copies the input and the
result of every solve dispatched around a sampled chunk (the result on
the solve's own stream, after it). After the window the reference tracks
the chunk's C frames from the first copy, is held to the C answers the
stream drained, runs each copied solve's input through its own local BA
(held to the program's result and cost), and merges the program's
results into its state in the order the stream merged them, to be held
to the second copy.
"""
from __future__ import annotations

import collections
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


def _clone_map(m):
    return type(m)(*(t.clone() for t in m))


def run(ctx):
    from kbslam_torch import config as program_config
    from kbslam_torch.geom.camera import Intrinsics as ProgramIntrinsics
    from kbslam_torch.pipeline import init_state
    from kbslam_torch.streaming import ChunkedStream

    dev = ctx.device
    cfg = config_dict(ctx)
    traffic = ctx.cell.traffic
    C = int(traffic["chunk"])
    rgb_d, depth_d, _ = scene.camera_frames(cfg, ctx.seed, dev)
    rgb = rgb_d[:, 0].cpu().numpy()
    depth = depth_d[:, 0].cpu().numpy().astype(np.uint16)
    del rgb_d, depth_d
    free_device(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    P = rgb.shape[0]
    K = scene.intrinsics(cfg["camera"])
    pcfg = slam_config(program_config, cfg["slam"])
    cs = ChunkedStream(pcfg, ProgramIntrinsics.from_matrix(K),
                       init_state(pcfg, dev), chunk=C, use_mask=False,
                       seed=ctx.seed, ba_mode=traffic["ba_mode"])
    solver = cs._async        # the stream's AsyncLocalBA (None with "off")
    drained = []
    warm = int(traffic["warmup_chunks"]) * C
    for i in range(warm):
        drained += cs.feed(rgb[i % P], depth[i % P])
    if dev.type == "cuda" and (cs.replays == 0 or (
            solver is not None and solver.inflight is None
            and not cs.ba_stats)):
        raise RuntimeError("warm-up left the chunk graph or the solve "
                           "uncaptured")

    chk = traffic["check"]
    rng = np.random.default_rng(ctx.seed)
    span = int(chk["within_chunks"])
    part = span // int(chk["chunks"])
    sampled = [k * part + 1 + int(rng.integers(0, part - 2))
               for k in range(int(chk["chunks"]))]
    # copies before the dispatching feed of chunk c and of c + 1; solves
    # dispatched from two chunks before c up to c + 1 keep their input
    before = peak_bytes(dev)
    snaps = {c: compare.empty_like_state(cs.state)
             for s in sampled for c in (s, s + 1)}
    keep_solves = {c for s in sampled for c in range(s - 2, s + 2)}
    trace_at = int(traffic["trace"]["start"]) * C
    traced = int(traffic["trace"]["chunks"]) * C
    tracer = Tracer(ctx.trace, dev.type == "cuda")
    sync(dev)

    setup_s = report.process_age_s()
    t0 = time.perf_counter()
    end = t0 + ctx.seconds
    j = in_window = n_dispatched = 0
    # solves dispatched and not yet merged, oldest first (None: before
    # the window, its input unknown); merges[c]: (solve, ba_stats index)
    pending = collections.deque(
        [None] if solver is not None and solver.inflight is not None else [])
    merges = collections.defaultdict(list)
    solves = {}          # solve number -> (input copy, result copy)
    last_inflight = solver.inflight if solver is not None else None
    n_stats = len(cs.ba_stats)
    last = max(max(snaps) * C, trace_at + traced if ctx.trace else 0)
    while True:
        c, pos = divmod(j, C)
        if pos == 0 and time.perf_counter() >= end and j > last:
            break
        if pos == C - 1 and c in snaps:
            compare.snapshot_into(snaps[c], cs.state)
        if j == trace_at:
            tracer.start()
        f = (warm + j) % P
        with tracer.span("dispatch" if pos == C - 1 else "feed", j):
            got = cs.feed(rgb[f], depth[f])
        drained += got
        in_window += len(got)
        j += 1
        if j == trace_at + traced:
            tracer.stop()
        if solver is None:
            continue
        # the interval of the chunk whose dispatch came last
        interval = (j - C) // C
        for rec in range(n_stats, len(cs.ba_stats)):
            merges[interval].append((pending.popleft(), rec))
        n_stats = len(cs.ba_stats)
        now = solver.inflight
        if now is not None and now is not last_inflight:
            if interval in keep_solves:
                snap = _clone_map(now.snapshot)
                with _on(solver, dev):
                    solves[n_dispatched] = (snap, _clone_map(now.result))
            pending.append(n_dispatched)
            n_dispatched += 1
        last_inflight = now
    window_s = time.perf_counter() - t0
    tracer.stop()
    fed = j
    drained += cs.flush()
    sync(dev)
    held = state_bytes(snaps.values()) + sum(
        t.numel() * t.element_size() for pair in solves.values()
        for m in pair for t in m)
    peak = program_peak(dev, before, held)
    costs = [r["final_cost"] for r in cs.ba_stats]
    # flush merged what was still pending, in order
    cost_of = {n: rec for recs in merges.values() for n, rec in recs}
    cost_of.update((n, n_stats + i) for i, n in enumerate(pending))
    replays = cs.replays
    results = [_program_answer(d) for d in drained[warm:]]
    lost = [i for i, a in enumerate(results[:fed]) if not a["success"]]
    failed = len(lost) + max(0, fed - len(results))
    del cs, solver
    free_device(dev)

    from slambench.reference import config as ref_config
    from slambench.reference import pipeline as ref_pipeline
    from slambench.reference.ba.local_ba import local_ba
    from slambench.reference.ba.merge import merge_ba_result
    from slambench.reference.geom.camera import Intrinsics

    rcfg = slam_config(ref_config, cfg["slam"])
    rintr = Intrinsics.from_matrix(K)
    step = ref_pipeline.make_track_step(rcfg, rintr, use_mask=False,
                                        seed=ctx.seed)
    modes = (False, True) if ctx.control else (False,)
    gaps, ctl_gaps = compare.Gaps(), compare.Gaps()
    unchecked = 0
    t_ref = time.perf_counter()
    for s in sampled:
        outs, maps = {}, {}
        for control in modes:
            st = compare.to_reference(ref_pipeline, snaps[s])
            kf0 = int(st.map.num_kf)
            outs[control] = []
            with tf32_products() if control else contextlib.nullcontext():
                for k in range(C):
                    f = (warm + s * C + k) % P
                    st, out = step(st, torch.from_numpy(rgb[f]).to(dev),
                                   torch.from_numpy(depth[f].astype(np.int32))
                                   .to(dev))
                    outs[control].append(out)
            maps[control] = st.map
        for k in range(C):
            gaps.answer(results[s * C + k], outs[False][k])
            if ctx.control:
                ctl_gaps.answer(_answer(outs[True][k]), outs[False][k])
        # the chunk's merges, with the program's solve results
        if any(n not in solves for n, _ in merges[s]):
            unchecked += 1
            continue
        for control in modes:
            for n, _ in merges[s]:
                maps[control] = merge_ba_result(maps[control], *solves[n],
                                                rcfg.ba)
        inserted = int(maps[False].num_kf) > kf0
        gaps.maps(snaps[s + 1].map, maps[False], inserted)
        if ctx.control:
            ctl_gaps.maps(maps[True], maps[False], inserted)
    for n, (snap, result) in solves.items():
        r_map, stats = local_ba(_clone_map(snap), rintr, rcfg.ba)
        rec = cost_of.get(n)
        gaps.solve(costs[rec] if rec is not None and rec < len(costs)
                   else None, float(stats.final_cost))
        gaps.maps(result, r_map, False)
        if ctx.control:
            with tf32_products():
                c_map, c_stats = local_ba(_clone_map(snap), rintr, rcfg.ba)
            ctl_gaps.solve(float(c_stats.final_cost), float(stats.final_cost))
            ctl_gaps.maps(c_map, r_map, False)
    ref_s = time.perf_counter() - t_ref

    fps = report.rate(in_window, window_s)
    layer = dict(profile=tracer.profile, chunk=C)
    if tracer.profile is not None:
        from slambench.harness import describe_bytes

        p = tracer.profile
        nbytes = 0
        for sp in p.spans:
            if sp.kind == "dispatch":
                for k in range(C):
                    f = (warm + sp.index - (C - 1) + k) % P
                    nbytes += describe_bytes.frame_bytes(
                        rcfg, rintr, torch.from_numpy(rgb[f]).to(dev),
                        torch.from_numpy(depth[f].astype(np.int32)).to(dev),
                        None)
        layer.update(describe_bytes=nbytes, **p.fields())
    info = [
        f"chunked: fed {fed} frames, {in_window} results back in "
        f"{window_s:.3f} s: {fps:.3f} frames/s; failed {failed}; chunk "
        f"replays {replays}; solves merged {len(costs)}; setup "
        f"{setup_s:.3f} s; peak {peak} bytes",
        f"chunked: frames of the window not tracked {lost}; solves merged "
        f"after the feed of their chunk "
        f"{[len(merges.get(i // C, ())) for i in lost]}",
        f"check: {len(sampled)} chunks ({unchecked} with a merge of an "
        f"uncopied solve: answers only), {len(solves)} solves against the "
        f"reference in {ref_s:.3f} s: {gaps.numbers()}",
    ]
    if ctx.control:
        info.append(f"control: {ctl_gaps.numbers()}")
    return Result(dict(frames_per_s=fps, setup_s=setup_s), fed, failed,
                  gaps.numbers(), peak, layer, info,
                  ctl_gaps.numbers() if ctx.control else None)


def _on(solver, dev):
    """The solve's own stream, so a copy of its result waits for it."""
    if dev.type == "cuda":
        return torch.cuda.stream(solver._stream)
    return contextlib.nullcontext()


def _program_answer(d: dict) -> dict:
    return dict(t=np.asarray(d["pose_t"]), R=compare.quat_matrix(d["pose_q"]),
                success=d["success"], added_kf=d["added_kf"],
                num_inliers=d["num_inliers"])


def _answer(out) -> dict:
    return dict(t=out.pose_t.double().cpu().numpy(),
                R=compare.quat_matrix(out.pose_q.cpu().numpy()),
                success=bool(out.success), added_kf=bool(out.added_kf),
                num_inliers=int(out.num_inliers))
