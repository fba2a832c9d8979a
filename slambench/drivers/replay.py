"""Driver ``replay``: a recorded sequence reconstructed densely, one frame
at a time, closed loop, through ``SLAM.process``.

The users are those who reconstruct recorded RGB-D sequences with the
CLI's per-frame path and the submap atlas (``--dense --dense-submaps K
--dense-icp refine``, no ``--chunk``): each frame is tracked, refined by
ICP against the newest submaps, and each keyframe runs its local BA and
is fused into the active submap before the next frame. The next frame
is sent as soon as the last one returned; the rate is the frames
answered in the window over its length. Set-up warms up until every
program the window replays is captured and ``warmup.submaps`` submaps
are open, so the window opens no graph.

The check (``harness/compare.py`` for the step and the local BA,
``harness/compare_dense.py`` for the ICP and the fusion) copies, during
the window, the program's state before each frame of a few stretches
drawn from the seed, the atlas's bookkeeping, the slots each stretch
reads or writes (at its start the active slot and the ICP window's, and
after each keyframe frame the active slot again); after the window the
reference runs each such frame from that state and is held to what the
program returned and to the slot it fused. On the card the reference
fuses ``check.slab_rows`` x rows at a time, beside the copies.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from slambench.harness import compare, compare_dense, manifest, report, scene
from slambench.harness.context import Result
from slambench.harness.control import tf32_products
from slambench.harness.setup import (config_dict, free_device, peak_bytes,
                                     program_peak, slam_config, state_bytes,
                                     sync)
from slambench.harness.trace import Tracer
from slambench.reference.mapping import submap as ref_submap

_live = manifest.load_module("drivers", "live")


def dense_config(config_module, slam: dict):
    """``slam_config`` with the dense section's JSON lists (``dims``,
    ``origin``) as tuples: a frozen configuration keys the programs'
    caches (``functools.lru_cache``), and a list cannot be a key."""
    keys = dict(slam)
    if "dense" in keys:
        keys["dense"] = {k: tuple(v) if isinstance(v, list) else v
                         for k, v in keys["dense"].items()}
    return slam_config(config_module, keys)


def _warm_up(slam, rgb, depth, mask, traffic, cuda: bool) -> int:
    """Frames until every program of ``traffic["programs"]`` is captured
    (on the card) and ``warmup.submaps`` submaps are open; raises past
    ``warmup.max_frames``."""
    w = traffic["warmup"]
    P = rgb.shape[0]
    i = 0
    while True:
        slam.process(rgb[i % P], depth[i % P], mask)
        i += 1
        ready = i >= int(w["min_frames"]) and (
            slam.atlas.count >= int(w["submaps"]))
        if cuda:
            ready = ready and all(slam.graphs.get(p) and slam.graphs[p].graphs
                                  for p in traffic["programs"])
        if ready:
            return i
        if i >= int(w["max_frames"]):
            missing = [p for p in traffic["programs"]
                       if not slam.graphs.get(p) or not slam.graphs[p].graphs]
            raise RuntimeError(f"warm-up of {i} frames left {missing} "
                               f"uncaptured, {slam.atlas.count} submaps")


def run(ctx):
    from kbslam_torch import config as program_config
    from kbslam_torch import device as program_device
    from kbslam_torch.slam import SLAM

    dev = ctx.device
    cuda = dev.type == "cuda"
    cfg = config_dict(ctx)
    traffic = ctx.cell.traffic
    rgb_d, depth_d, gt = scene.camera_frames(cfg, ctx.seed, dev)
    rgb = rgb_d[:, 0].cpu().numpy()
    depth = depth_d[:, 0].cpu().numpy().astype(np.uint16)
    gt = gt[:, 0]
    del rgb_d, depth_d
    free_device(dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    P = rgb.shape[0]
    mask = np.full(depth.shape[1:], 255, np.uint8)
    K = scene.intrinsics(cfg["camera"])
    pcfg = dense_config(program_config, cfg["slam"])
    slam = SLAM(pcfg, K, ba_mode=traffic["ba_mode"], use_mask=True,
                seed=ctx.seed, device=dev)
    warm = _warm_up(slam, rgb, depth, mask, traffic, cuda)

    chk = traffic["check"]
    L = int(chk["stretch_frames"])
    starts = _live.stretches(ctx.seed, int(chk["within_frames"]),
                             int(chk["stretches"]), L)
    window_k = pcfg.dense_icp.atlas_slots
    before = peak_bytes(dev)
    snaps = {j: compare.empty_like_state(slam.state)
             for s in starts for j in range(s, s + L + 1)}
    metas, views, posts = {}, {}, {}
    content = {}            # ring slot -> its copy as it stands now
    trace_at = int(traffic["trace"]["start"])
    traced = int(traffic["trace"]["frames"])
    tracer = Tracer(ctx.trace, cuda)
    captures0 = sum(program_device.captures.values())
    sync(dev)

    setup_s = report.process_age_s()
    t0 = time.perf_counter()
    end = t0 + ctx.seconds
    last = max(max(snaps), trace_at + traced if ctx.trace else 0)
    done = []               # host clock as each frame returned
    j = 0
    while time.perf_counter() < end or j <= last:
        if j in snaps:
            atlas = slam.atlas
            compare.snapshot_into(snaps[j], slam.state)
            if j in starts:
                # the active slot and the refine's window: the newest
                # live slots, newest first
                live = ref_submap.live_slots(atlas.count, atlas.capacity)
                content = {s: compare_dense.copy_slot(atlas, s)
                           for s in live[::-1][:1 + window_k]}
            metas[j] = compare_dense.copy_meta(atlas)
            views[j] = dict(content)
        if j == trace_at:
            tracer.start()
        f = (warm + j) % P
        with tracer.span("frame", j):
            d = slam.process(rgb[f], depth[f], mask)
        done.append(time.perf_counter())
        if d["added_kf"] and j in snaps and j + 1 in snaps:
            a = slam.atlas.active_slot()
            content[a] = posts[j] = compare_dense.copy_slot(slam.atlas, a)
        j += 1
        if j == trace_at + traced:
            tracer.stop()
    window_s = time.perf_counter() - t0
    tracer.stop()
    N = j
    sync(dev)
    copies = {id(c): c for v in views.values() for c in v.values()}
    copies.update((id(c), c) for c in posts.values())
    held = state_bytes(snaps.values()) + sum(
        t.numel() * t.element_size() for c in copies.values() for t in c)
    peak = program_peak(dev, before, held)
    captured = sum(program_device.captures.values()) - captures0
    if captured:
        raise RuntimeError(f"{captured} capture(s) inside the window")

    diags = slam.diagnostics
    events = {e["frame"]: e for e in slam.icp_events}
    costs = iter(slam.ba_stats)
    cost_of = {i: next(costs)["final_cost"] for i, x in enumerate(diags)
               if x["ran_ba"]}
    poses = slam.frame_poses
    fused_before = np.cumsum([0] + [int(x["added_kf"]) for x in diags])
    window = diags[warm:warm + N]
    failed = sum(not x["success"] for x in window)
    icp_run = sum(warm + i in events for i in range(N))
    icp_ok = sum(events[warm + i]["accepted"] for i in range(N)
                 if warm + i in events)
    keyframes = sum(x["added_kf"] for x in window)
    est = np.stack([poses[warm + i][:3, 3] for i in range(N)])
    truth = gt[[(warm + i) % P for i in range(N)], :3, 3]
    replays = {k: g.replays for k, g in slam.graphs.items()}
    submaps = slam.atlas.count
    del slam, atlas
    free_device(dev)

    from slambench.harness.trajectory import ate_rmse
    from slambench.reference import config as ref_config
    from slambench.reference import pipeline as ref_pipeline
    from slambench.reference.ba.local_ba import local_ba
    from slambench.reference.geom.camera import Intrinsics
    from slambench.reference.geom.se3 import SE3, matrix_to_quat
    from slambench.reference.mapping import dense as ref_dense
    from slambench.reference.mapping import icp as ref_icp

    rcfg = dense_config(ref_config, cfg["slam"])
    rintr = Intrinsics.from_matrix(K)
    step = ref_pipeline.make_track_step(rcfg, rintr, use_mask=True,
                                        seed=ctx.seed)
    slab = int(chk["slab_rows"])
    scale = rcfg.map.depth_scale
    mask_t = torch.from_numpy(mask).to(dev)

    def rescue_start(g, q, t):
        """The pose a rescue at global frame ``g`` starts from, as the
        shell chains it: the last accepted rescue's since the last tracked
        frame, else the held pose (q, t)."""
        for k in range(g - 1, -1, -1):
            ev = events.get(k)
            rescued = ev is not None and ev["mode"] == "rescue"
            if rescued and ev["accepted"]:
                T = torch.as_tensor(poses[k], dtype=torch.float32,
                                    device=dev)
                return matrix_to_quat(T[:3, :3]), T[:3, 3]
            if diags[k]["success"] and not rescued:
                break
        return q, t

    def reference_frame(st, frame, atlas, g, control):
        """The reference's step, local BA, ICP and fusion of global frame
        ``g`` from the state ``st`` and the atlas before it."""
        with tf32_products() if control else contextlib.nullcontext():
            new, out = step(st, *frame)
            cost = None
            if bool(out.added_kf) and traffic["ba_mode"] == "on_keyframe":
                m, stats = local_ba(new.map, rintr, rcfg.ba)
                new = new._replace(map=m)
                cost = float(stats.final_cost)
            depth_m = frame[1].to(torch.float32) * scale
            ok, kf = bool(out.success), bool(out.added_kf)
            q, t = out.pose_q, out.pose_t
            icp = dict(ran=False, accepted=False, n=0)
            mode = rcfg.dense_icp.mode
            if mode != "off" and (not ok or (mode == "refine" and not kf)):
                q0, t0 = (q, t) if ok else rescue_start(g, q, t)
                win = ref_submap.recent_slots_with_poses(
                    atlas, new.map, rcfg.dense_icp.atlas_slots, ok)
                if win is not None:
                    slots, aq, at = win
                    res = ref_icp.align_depth_to_atlas(
                        [atlas.volumes[s] for s in slots], aq, at, depth_m,
                        q0, t0, rintr, rcfg.dense, rcfg.dense_icp)
                    acc = ref_icp.accepted(res, rcfg.dense_icp, ok)
                    icp = dict(ran=True, accepted=acc,
                               n=int(res.num_valid))
                    if acc:
                        q, t = res.q, res.t
            icp.update(compare_dense.pose_answer(q, t))
            fusion = None
            if kf:
                fusion = ref_submap.fuse_keyframe(
                    atlas, int(fused_before[g]), rcfg.dense.submap_every,
                    int(new.map.num_kf) - 1, depth_m, q, t, new.map, rintr,
                    rcfg.dense, slab)
        answer = dict(compare_dense.pose_answer(out.pose_q, out.pose_t),
                      success=ok, added_kf=kf,
                      num_inliers=int(out.num_inliers), cost=cost)
        return answer, out, new.map, icp, fusion, depth_m

    gaps, ctl_gaps = compare.Gaps(), compare.Gaps()
    dgaps, ctl_dgaps = compare_dense.DenseGaps(), compare_dense.DenseGaps()
    t_ref = time.perf_counter()
    for s in starts:
        for j in range(s, s + L):
            g = warm + j
            f = g % P
            frame = (torch.from_numpy(rgb[f]).to(dev),
                     torch.from_numpy(depth[f].astype(np.int32)).to(dev),
                     mask_t)
            count, aq, at, ids = metas[j]
            atlas = ref_submap.Atlas(count, aq.shape[0], aq, at, ids,
                                     {k: ref_dense.TSDFState(*c)
                                      for k, c in views[j].items()})
            ev = events.get(g)
            prog = dict(compare_dense.pose_answer(snaps[j + 1].pose_q,
                                                  snaps[j + 1].pose_t),
                        success=diags[g]["success"] and not (
                            ev is not None and ev["mode"] == "rescue"),
                        added_kf=diags[g]["added_kf"],
                        num_inliers=diags[g]["num_inliers"],
                        cost=cost_of.get(g))
            prog_icp = dict(ran=ev is not None,
                            accepted=ev is not None and ev["accepted"],
                            n=ev["num_valid"] if ev is not None else 0,
                            R=poses[g][:3, :3], t=poses[g][:3, 3])
            st = compare.to_reference(ref_pipeline, snaps[j])
            r_ans, r_out, r_map, r_icp, r_fuse, depth_m = reference_frame(
                st, frame, atlas, g, False)
            gaps.frame(prog, r_out, snaps[j + 1].map, r_map, prog["cost"],
                       r_ans["cost"])
            dgaps.icp(prog_icp, r_icp)
            ctl = None
            if ctx.control:
                st = compare.to_reference(ref_pipeline, snaps[j])
                ctl = reference_frame(st, frame, atlas, g, True)
                ctl_gaps.frame(ctl[0], r_out, ctl[2], r_map, ctl[0]["cost"],
                               r_ans["cost"])
                ctl_dgaps.icp(ctl[3], r_icp)
            if r_fuse is None:
                continue
            r_atlas, r_slot, r_local = r_fuse
            opened = int(fused_before[g]) % rcfg.dense.submap_every == 0
            before_slot = (ref_dense.empty_tsdf(rcfg.dense.dims, dev)
                           if opened else atlas.volumes[r_slot])
            r_vol = r_atlas.volumes[r_slot]
            if diags[g]["added_kf"] and j in posts:
                # the program fused at its step's pose, in the frame of the
                # anchor pose it stored back
                _, a_q, a_t, _ = metas[j + 1]
                p_local = (SE3(a_q[r_slot], a_t[r_slot]).inverse()
                           @ SE3(snaps[j + 1].pose_q, snaps[j + 1].pose_t))
                dgaps.fusion(before_slot, posts[j], r_vol,
                             compare_dense.keep_rule(rcfg.dense, rintr,
                                                     depth_m, p_local,
                                                     r_local), slab)
            if ctl is not None and ctl[4] is not None:
                c_atlas, c_slot, c_local = ctl[4]
                ctl_dgaps.fusion(before_slot, c_atlas.volumes[c_slot], r_vol,
                                 compare_dense.keep_rule(
                                     rcfg.dense, rintr, depth_m, c_local,
                                     r_local), slab)
    ref_s = time.perf_counter() - t_ref

    fps = report.rate(N, window_s)
    numbers = dict(gaps.numbers(), **dgaps.numbers())
    info = [
        f"replay: {N} frames in {window_s:.3f} s: {fps:.3f} frames/s; "
        f"failed {failed}; keyframes {keyframes}; ICP solves {icp_run}, "
        f"accepted {icp_ok}; submaps opened {submaps}; warm-up {warm} "
        f"frames; setup {setup_s:.3f} s; peak {peak} bytes",
        f"replay: replays {replays}; captures in the window {captured}; "
        f"ATE against the sweep {ate_rmse(est, truth) * 1e3:.3f} mm",
        f"replay: frames/s in each fifth of the window "
        f"{_fifths(t0, window_s, done)}",
        f"check: {gaps.frames} frames, {gaps.solves} solves, "
        f"{dgaps.icp_frames} ICP frames, {dgaps.fusions} fusions against "
        f"the reference in {ref_s:.3f} s: {numbers}",
    ]
    ctl_numbers = None
    if ctx.control:
        ctl_numbers = dict(ctl_gaps.numbers(), **ctl_dgaps.numbers())
        info.append(f"control: {ctl_numbers}")
    layer = dict(profile=tracer.profile)
    if tracer.profile is not None:
        from slambench.harness import dense_bytes

        layer.update(dense_fuse_bytes=dense_bytes.fuse_bytes(rcfg),
                     dense_icp_bytes=dense_bytes.icp_bytes(rcfg),
                     **tracer.profile.fields())
    return Result(dict(frames_per_s=fps, setup_s=setup_s), N, failed,
                  numbers, peak, layer, info, ctl_numbers)


def _fifths(t0: float, window_s: float, done: list) -> list:
    """Frames answered in each fifth of the window, per second."""
    part = window_s / 5
    counts = np.bincount(np.minimum(((np.asarray(done) - t0) // part)
                                    .astype(int), 4), minlength=5)
    return [round(float(c) / part, 3) for c in counts[:5]]
