"""Driver ``fleet``: S recorded streams, closed loop, one batched step of
every stream per frame (``parallel.multistream.make_multistream_step``:
tracking with immediate insertion, no mask, no BA).

Each step takes the S streams' next frames from pinned host memory (the
step copies them to the card), replays the batched program and reads
its outputs back; the next step starts when they are back. The rate is
the frames of every stream whose results came back in the window over
the window's length.

As in ``live``, the state of every stream before each step of a few
stretches drawn from the seed is copied on the device during the window,
and afterwards the reference tracks ``check.streams`` streams drawn from
the seed through every such step, each on its own (the single-stream
step, with the stream's RANSAC counter ``frame * S + s``), and is held to
the program's answer and the stream's state after. A stretch of more
steps than the keyframe policy's minimum gap holds an insertion of
every stream. With the control (``control.py``) the program's own
single-stream step on the same states is read as a second witness.
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
                                     sync, to_host)
from slambench.harness.trace import Tracer


def host_rows(out) -> torch.Tensor:
    """[S, 10] on the host: pose t (3), pose q (4), success, added_kf,
    inlier count; one copy."""
    return torch.cat([out.pose_t, out.pose_q,
                      torch.stack([out.success.float(), out.added_kf.float(),
                                   out.num_inliers.float()], -1)],
                     -1).double().cpu()


def answer(row) -> dict:
    r = row.numpy()
    return dict(t=r[:3], R=compare.quat_matrix(r[3:7]), success=r[7] > 0,
                added_kf=r[8] > 0, num_inliers=int(r[9]))


def _answer(out) -> dict:
    return dict(t=out.pose_t.double().cpu().numpy(),
                R=compare.quat_matrix(out.pose_q.cpu().numpy()),
                success=bool(out.success), added_kf=bool(out.added_kf),
                num_inliers=int(out.num_inliers))


def _single_stream(state, s: int, frame, pcfg, K, seed: int, S: int):
    """A second witness (control readings only): the program's own
    single-stream step on stream ``s`` of the same state, with the
    stream's RANSAC counter: (its output, its map after)."""
    from kbslam_torch import pipeline
    from kbslam_torch.geom.camera import Intrinsics as ProgramIntrinsics
    from kbslam_torch.mapping.state import MapState as ProgramMap
    from kbslam_torch.pnp.ransac import hash_sampler

    st = pipeline.TrackState(ProgramMap(*(t[s].clone() for t in state.map)),
                             *(t[s].clone() for t in state[1:]))
    sampler = hash_sampler(seed, st.frame_count * S + s)
    new, out = pipeline.track_step(st, *frame, None,
                                   ProgramIntrinsics.from_matrix(K), pcfg,
                                   sampler)
    return out, new.map


def stream_state(ref_pipeline, state, s: int):
    """Stream ``s`` of a stream-batched state as the reference's state."""
    from slambench.reference.mapping.state import MapState

    return ref_pipeline.TrackState(MapState(*(t[s].clone() for t in state.map)),
                                   *(t[s].clone() for t in state[1:]))


def run(ctx, step_factory=None):
    """``step_factory(cfg, intr, S, seed)`` replaces
    ``make_multistream_step`` (the tests plant faults so)."""
    from kbslam_torch import config as program_config
    from kbslam_torch import device as program_device
    from kbslam_torch.geom.camera import Intrinsics as ProgramIntrinsics
    from kbslam_torch.parallel.multistream import (batched_init_state,
                                                   make_multistream_step)

    dev = ctx.device
    cfg = config_dict(ctx)
    traffic = ctx.cell.traffic
    S = int(cfg["streams"])
    rgb_d, depth_d, _ = scene.camera_frames(cfg, ctx.seed, dev, S)
    rgb, depth = to_host(rgb_d), to_host(depth_d)
    del rgb_d, depth_d
    free_device(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    P = rgb.shape[0]
    K = scene.intrinsics(cfg["camera"])
    pcfg = slam_config(program_config, cfg["slam"])
    factory = step_factory or (lambda c, i, n, s: make_multistream_step(
        c, i, n, seed=s))
    step = factory(pcfg, ProgramIntrinsics.from_matrix(K), S, ctx.seed)
    state = batched_init_state(pcfg, S, dev)
    warm = int(traffic["warmup_steps"])
    for k in range(warm):
        state, out = step(state, rgb[k % P], depth[k % P])
        host_rows(out)

    chk = traffic["check"]
    L = int(chk["stretch_steps"])
    rng = np.random.default_rng(ctx.seed)
    span = int(chk["within_steps"])
    part = span // int(chk["stretches"])
    starts = [k * part + int(rng.integers(0, part - L))
              for k in range(int(chk["stretches"]))]
    checked = sorted(int(x) for x in rng.choice(
        S, size=min(S, int(chk["streams"])), replace=False))
    before = peak_bytes(dev)
    snaps = {j: compare.empty_like_state(state)
             for s in starts for j in range(s, s + L + 1)}
    trace_at = int(traffic["trace"]["start"])
    traced = int(traffic["trace"]["steps"])
    tracer = Tracer(ctx.trace, dev.type == "cuda")
    captures0 = sum(program_device.captures.values())
    sync(dev)

    setup_s = report.process_age_s()
    rows = []
    t0 = time.perf_counter()
    end = t0 + ctx.seconds
    k = 0
    last = max(max(snaps), trace_at + traced if ctx.trace else 0)
    while time.perf_counter() < end or k <= last:
        if k in snaps:
            compare.snapshot_into(snaps[k], state)
        if k == trace_at:
            tracer.start()
        f = (warm + k) % P
        with tracer.span("step", k):
            state, out = step(state, rgb[f], depth[f])
            rows.append(host_rows(out))
        k += 1
        if k == trace_at + traced:
            tracer.stop()
    tracer.stop()
    window_s = time.perf_counter() - t0
    steps = k
    sync(dev)
    peak = program_peak(dev, before, state_bytes(snaps.values()))
    captured = sum(program_device.captures.values()) - captures0
    if captured:
        raise RuntimeError(f"{captured} capture(s) inside the window")
    answers = [[answer(r) for r in step_rows] for step_rows in rows]
    failed = sum(not a["success"] for s_ in answers for a in s_)
    replays = getattr(getattr(step, "program", None), "replays", None)
    del step, state, out
    free_device(dev)

    from slambench.harness import describe_bytes
    from slambench.reference import config as ref_config
    from slambench.reference import pipeline as ref_pipeline
    from slambench.reference.geom.camera import Intrinsics
    from slambench.reference.pnp.ransac import hash_sampler

    rcfg = slam_config(ref_config, cfg["slam"])
    rintr = Intrinsics.from_matrix(K)
    gaps, ctl_gaps, wit_gaps = compare.Gaps(), compare.Gaps(), compare.Gaps()
    t_ref = time.perf_counter()
    for s0 in starts:
        for j in range(s0, s0 + L):
            f = (warm + j) % P
            for s in checked:
                frame = (rgb[f, s].to(dev), depth[f, s].to(dev))
                modes = (False, True) if ctx.control else (False,)
                res = {}
                for control in modes:
                    st = stream_state(ref_pipeline, snaps[j], s)
                    sampler = hash_sampler(ctx.seed,
                                           st.frame_count * S + s)
                    with (tf32_products() if control
                          else contextlib.nullcontext()):
                        new, o = ref_pipeline.track_step(
                            st, *frame, None, rintr, rcfg, sampler)
                    res[control] = (o, new.map)
                r_out, r_map = res[False]
                after = stream_state(ref_pipeline, snaps[j + 1], s).map
                gaps.frame(answers[j][s], r_out, after, r_map, stream=s)
                if ctx.control:
                    c_out, c_map = res[True]
                    ctl_gaps.frame(_answer(c_out), r_out, c_map, r_map,
                                   stream=s)
                    w_out, w_map = _single_stream(snaps[j], s, frame, pcfg,
                                                  K, ctx.seed, S)
                    wit_gaps.frame(_answer(w_out), r_out, w_map, r_map,
                                   stream=s)
    ref_s = time.perf_counter() - t_ref

    layer = dict(profile=tracer.profile)
    if tracer.profile is not None:
        p = tracer.profile
        traced_steps = [sp.index for sp in p.spans if sp.kind == "step"]
        nbytes = 0
        for j in traced_steps:
            f = (warm + j) % P
            for s in range(S):
                nbytes += describe_bytes.frame_bytes(
                    rcfg, rintr, rgb[f, s].to(dev), depth[f, s].to(dev), None)
        layer.update(describe_bytes=nbytes, **p.fields())
    fps = report.rate(steps * S, window_s)
    info = [
        f"fleet: {steps} steps of {S} streams in {window_s:.3f} s: "
        f"{fps:.3f} frames/s; failed {failed}; replays {replays}; "
        f"captures in the window {captured}; setup {setup_s:.3f} s; "
        f"peak {peak} bytes",
        f"check: streams {checked}, {gaps.frames} stream-frames against "
        f"the reference in "
        f"{ref_s:.3f} s: {gaps.numbers()}",
    ]
    if ctx.control:
        info.append(f"control: {ctl_gaps.numbers()}")
        info.append(f"witness (the program's single-stream step): "
                    f"{wit_gaps.numbers()}")
    return Result(dict(frames_per_s=fps, setup_s=setup_s), steps * S, failed,
                  gaps.numbers(), peak, layer, info,
                  ctl_gaps.numbers() if ctx.control else None)
