"""The per-frame tracking step (port of kbslam/pipeline.py).

extract ORB -> match against the last keyframe -> PnP-RANSAC -> pose ->
keyframe policy -> masked keyframe insertion and landmark creation, as
eager torch on one device. The step makes no host round trip: every
decision (success, insertion) stays a device tensor and gates the map
writes by masking.

With ``track_keyframes = NK > 1`` the frame is matched against a bank
of the last NK keyframes, gathered by one ``index_select`` of their ring
slots, with the bank's points in the world frame.

With ``defer_insert=True`` the step leaves the map alone and returns
what the insertion needs (``PendingInsert``); ``apply_pending`` inserts
it later. The multistream scan (``parallel/multistream.py``) applies
each stream's pending insertion once per block of frames.

``track_step_batched`` is the same step over S streams stacked on a
leading axis of every state, frame and output tensor: the port's
counterpart of the reference's ``jax.vmap(track_step)`` (config 4). It
runs every stage at once for all S (one describe launch over S x F
keypoints, a batched Hamming product, S x K hypotheses) and each stream
decides for itself; ``apply_pending_batched`` applies S pending
insertions. On the CPU each stream's result equals ``track_step`` on
that stream to the bit.

The shells keep one live state and write each step's result into its
tensors (``track_step_into``, through ``device.assign_state``), the
counterpart of the reference's donated state: on CUDA the per-frame
shell replays it as one CUDA graph (``device.LiveGraphs``) on that state
and on static frame buffers, and ``output_rows`` packs its outputs into
the one row the host reads per frame.

Both steps mark their stage edges (``utils.profiling.mark``): ``frontend``
ends after ``extract_frame``, ``match`` after the top-M compaction,
``pnp`` after PnP-RANSAC, its polish and the inlier ratio, and ``map`` at
the end (policy, insertion, landmark fusion). Inside a CUDA graph each
mark is a one-thread kernel that times the edge on the device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from kbslam_torch.device import assign_state
from kbslam_torch.frontend import orb
from kbslam_torch.geom.camera import Intrinsics, depth_at, project, unproject
from kbslam_torch.geom.se3 import SE3
from kbslam_torch.mapping import policy as kf_policy
from kbslam_torch.mapping.state import (MapState, create_map_points,
                                        create_map_points_batched,
                                        device_copy, empty_map,
                                        insert_keyframe,
                                        insert_keyframe_batched, take_row,
                                        take_rows)
from kbslam_torch.matching.hamming import MatchResult, knn2_ratio_match
from kbslam_torch.ops.incidence import incidence_gather
from kbslam_torch.pnp.ransac import (Sampler, hash_sampler, ransac_pnp,
                                    ransac_pnp_batched)
from kbslam_torch.utils.profiling import mark


class TrackState(NamedTuple):
    map: MapState
    pose_q: torch.Tensor            # current camera pose T_wc
    pose_t: torch.Tensor
    frames_since_kf: torch.Tensor   # [] int32
    # [] int32 on the device, as in the reference: the frame's RANSAC
    # draws hash it, so a replayed CUDA graph draws each frame's own sets
    frame_count: torch.Tensor

    @property
    def pose(self) -> SE3:
        return SE3(self.pose_q, self.pose_t)


class TrackOutput(NamedTuple):
    pose_q: torch.Tensor
    pose_t: torch.Tensor
    success: torch.Tensor       # bool — a new pose was estimated
    added_kf: torch.Tensor      # bool
    inlier_ratio: torch.Tensor  # float32
    num_matches: torch.Tensor   # int ratio-test survivors
    num_inliers: torch.Tensor   # int
    num_features: torch.Tensor  # int valid ORB keypoints
    # newest keyframe after this frame's insertion, with its pose
    anchor_id: torch.Tensor     # int (-1 = no keyframe yet)
    anchor_q: torch.Tensor      # [4]
    anchor_t: torch.Tensor      # [3]


_OUTPUT_FIELDS = ("pose_q", "pose_t", "success", "added_kf", "inlier_ratio",
                  "num_matches", "num_inliers", "num_features", "anchor_id",
                  "anchor_q", "anchor_t")
_FIELD_WIDTH = {f: 4 if f.endswith("_q") else 3 if f.endswith("_t") else 1
                for f in _OUTPUT_FIELDS}
OUTPUT_WIDTH = sum(_FIELD_WIDTH.values())    # a row of output_rows


def output_rows(out) -> torch.Tensor:
    """TrackOutputs stacked over a leading frame axis [n, ...] -> one
    [n, OUTPUT_WIDTH] float64 tensor on their device, a row per frame
    (the integers are small and exact in float64)."""
    n = out.pose_q.shape[0]
    return torch.cat([getattr(out, f).reshape(n, -1).to(torch.float64)
                      for f in _OUTPUT_FIELDS], dim=1)


def row_to_fields(row) -> dict:
    """One row of ``output_rows``, read back on the host, as a dict of
    the TrackOutput fields (vectors as arrays, scalars as floats)."""
    res, i = {}, 0
    for f in _OUTPUT_FIELDS:
        n = _FIELD_WIDTH[f]
        res[f] = row[i:i + n] if n > 1 else row[i]
        i += n
    return res


class PendingInsert(NamedTuple):
    """A keyframe insertion captured at the frame that flagged it, to be
    applied later (``apply_pending``); ``do`` False is a no-op. It lands
    up to K - 1 frames late when applied once per K frames; frames in
    between keep matching the previous keyframe. S streams' insertions
    carry a leading S on every field (``apply_pending_batched``)."""

    do: torch.Tensor        # [] bool: a keyframe was flagged
    fresh: torch.Tensor     # [] bool: the map was empty (no fusion)
    pose_q: torch.Tensor    # [4]
    pose_t: torch.Tensor    # [3]
    kp_xy: torch.Tensor     # [F, 2]
    kp_depth: torch.Tensor  # [F]
    kp_desc: torch.Tensor   # [F, 256] uint8
    kp_valid: torch.Tensor  # [F] bool
    fuse_idx: torch.Tensor  # [F] int32 match.best_idx against the last KF
    fuse_ok: torch.Tensor   # [F] bool match.is_match against the last KF


def empty_pending(cfg, device, batch: tuple = ()) -> PendingInsert:
    """No insertion pending (for each of ``batch`` streams). Built by
    fill kernels alone (no copy from the host), so it can be made inside
    a CUDA graph capture."""
    F = cfg.orb.max_features
    b = tuple(batch)
    identity = SE3.identity(batch_shape=b, device=device)
    return PendingInsert(
        do=torch.zeros(b, dtype=torch.bool, device=device),
        fresh=torch.zeros(b, dtype=torch.bool, device=device),
        pose_q=identity.q, pose_t=identity.t,
        kp_xy=torch.zeros(b + (F, 2), device=device),
        kp_depth=torch.zeros(b + (F,), device=device),
        kp_desc=torch.zeros(b + (F, 256), dtype=torch.uint8, device=device),
        kp_valid=torch.zeros(b + (F,), dtype=torch.bool, device=device),
        fuse_idx=torch.zeros(b + (F,), dtype=torch.int32, device=device),
        fuse_ok=torch.zeros(b + (F,), dtype=torch.bool, device=device))


def apply_pending(m: MapState, p: PendingInsert, intr: Intrinsics
                  ) -> MapState:
    """Insert one deferred keyframe and its landmarks, masked by
    ``p.do`` as the immediate insertion is. The keypoints' response,
    angle and level are not stored in the map, so they go in as zeros."""
    zf = torch.zeros_like(p.kp_depth)
    feats = orb.Features(xy=p.kp_xy, response=zf, angle=zf,
                         level=torch.zeros_like(p.fuse_idx),
                         valid=p.kp_valid, desc=p.kp_desc)
    m = insert_keyframe(m, feats, p.kp_depth, SE3(p.pose_q, p.pose_t),
                        do=p.do)
    zi = torch.zeros_like(p.fuse_idx)
    fuse = MatchResult(best_idx=p.fuse_idx, best_dist=zi, second_dist=zi,
                       is_match=p.fuse_ok)
    return create_map_points(m, fuse, intr.fx, intr.fy, intr.cx, intr.cy,
                             do=p.do & ~p.fresh)


def apply_pending_batched(m: MapState, p: PendingInsert, intr: Intrinsics
                          ) -> MapState:
    """``apply_pending`` on S stacked maps, stream s inserting where
    p.do[s]."""
    zf = torch.zeros_like(p.kp_depth)
    feats = orb.Features(xy=p.kp_xy, response=zf, angle=zf,
                         level=torch.zeros_like(p.fuse_idx),
                         valid=p.kp_valid, desc=p.kp_desc)
    m = insert_keyframe_batched(m, feats, p.kp_depth,
                                SE3(p.pose_q, p.pose_t), do=p.do)
    zi = torch.zeros_like(p.fuse_idx)
    fuse = MatchResult(best_idx=p.fuse_idx, best_dist=zi, second_dist=zi,
                       is_match=p.fuse_ok)
    return create_map_points_batched(m, fuse, intr.fx, intr.fy, intr.cx,
                                     intr.cy, do=p.do & ~p.fresh)


def clone_state(state: TrackState) -> TrackState:
    """A state whose every tensor is a fresh copy."""
    return TrackState(device_copy(state.map),
                      *(t.clone() for t in state[1:]))


def init_state(cfg, device) -> TrackState:
    return TrackState(
        map=empty_map(cfg.map, cfg.orb, device),
        pose_q=torch.tensor([1.0, 0, 0, 0], device=device),
        pose_t=torch.zeros(3, device=device),
        frames_since_kf=torch.zeros((), dtype=torch.int32, device=device),
        frame_count=torch.zeros((), dtype=torch.int32, device=device),
    )


def _pool3x3(x: torch.Tensor, sign: float) -> torch.Tensor:
    """3x3 'SAME' max (sign=1) or min (sign=-1) of [..., H, W] float32."""
    planes = (sign * x).reshape((-1, 1) + x.shape[-2:])
    return sign * F.max_pool2d(planes, 3, stride=1,
                               padding=1).reshape(x.shape)


def extract_frame(rgb, depth, mask, intr: Intrinsics, cfg,
                  batched: bool = False):
    """ORB under the mask, keypoint depth with the occlusion-rim gate,
    and one-shot undistortion. depth is [H, W] int32 raw units; with
    ``batched``, every input has a leading stream axis."""
    feats = orb.extract(rgb, mask, cfg.orb, batched)
    depth_kp = depth_at(depth, feats.xy, cfg.map.depth_scale)
    if cfg.map.depth_edge_max_spread > 0:
        # occlusion-rim gate: 3x3 max and hole-aware min of the depth
        # image (float32 is exact for 16-bit depth), read at keypoints
        d = depth.to(torch.float32)
        dmax = _pool3x3(d, 1.0)
        dmin = _pool3x3(torch.where(d > 0, d, 65535.0), -1.0)
        spread = (depth_at(dmax, feats.xy, cfg.map.depth_scale)
                  - depth_at(dmin, feats.xy, cfg.map.depth_scale))
        thr = cfg.map.depth_edge_max_spread
        if cfg.map.depth_edge_rel_per_m2 > 0:
            thr = torch.clamp(cfg.map.depth_edge_rel_per_m2 * depth_kp ** 2,
                              min=thr)
        depth_kp = torch.where(spread <= thr, depth_kp, 0.0)
    if intr.has_distortion:
        from kbslam_torch.geom.camera import undistort_points

        feats = feats._replace(xy=undistort_points(intr, feats.xy))
    return feats, depth_kp


def track_step(state: TrackState, rgb: torch.Tensor, depth: torch.Tensor,
               mask: Optional[torch.Tensor], intr: Intrinsics, cfg,
               sampler: Sampler, defer_insert: bool = False):
    """One frame: rgb [H, W, 3] uint8, depth [H, W] int32, mask [H, W]
    (nonzero = keep) or None -> (new state, TrackOutput). ``sampler``
    draws RANSAC's minimal sets (see kbslam_torch.pnp.ransac). With
    ``defer_insert`` the map is left as it is and a third element, the
    ``PendingInsert``, is returned."""
    m = state.map
    mark(None, rgb)
    empty = m.is_empty()
    feats, depth_kp = extract_frame(rgb, depth, mask, intr, cfg)
    mark("frontend", rgb)

    # --- match against the last keyframe(s) ----------------------------------
    slot = m.last_slot()
    NK = max(1, int(cfg.track_keyframes))
    if NK == 1:
        q_desc = take_row(m.kf_desc, slot)
        q_valid = take_row(m.kf_kp_valid, slot) & ~empty
        pts3d = unproject(intr, take_row(m.kf_kp_xy, slot),
                          take_row(m.kf_kp_depth, slot))
    else:
        # the last NK keyframes, newest first, in one gather of their
        # slots; the bank's points are in the world frame, so one PnP
        # constrains against all of them
        ids = m.num_kf - 1 - torch.arange(NK, dtype=torch.int32,
                                          device=m.num_kf.device)
        kslots = torch.remainder(torch.clamp(ids, min=0),
                                 m.capacity_kf).to(torch.int64)

        def bank(arr):
            return arr.index_select(0, kslots)              # [NK, ...]

        q_desc = bank(m.kf_desc).reshape(-1, m.kf_desc.shape[-1])
        q_valid = ((bank(m.kf_kp_valid) & (ids >= 0)[:, None]).reshape(-1)
                   & ~empty)
        p_cam = unproject(intr, bank(m.kf_kp_xy), bank(m.kf_kp_depth))
        kf_T = SE3(bank(m.kf_q)[:, None, :], bank(m.kf_t)[:, None, :])
        pts3d = kf_T.apply(p_cam).reshape(-1, 3)
    match = knn2_ratio_match(q_desc, q_valid, feats.desc, feats.valid,
                             cfg.matcher.ratio,
                             cross_check=cfg.matcher.cross_check)
    num_matches = torch.sum(match.is_match.to(torch.int32))
    attempted = (num_matches >= cfg.pnp.min_points) & ~empty

    # --- compaction: the top-M matches by Hamming distance, packed first ----
    M = min(cfg.pnp.max_correspondences, q_desc.shape[0])
    score = torch.where(match.is_match, match.best_dist.to(torch.float32),
                        torch.inf)
    _, cidx = orb.topk_stable(-score, M)
    sel_valid = match.is_match[cidx]
    pts3d_m = incidence_gather(cidx, pts3d)                     # [M, 3]
    t_idx = match.best_idx[cidx].to(torch.int64)                # [M]
    train_tab = torch.cat([feats.xy, depth_kp[:, None]], dim=1)
    train_m = incidence_gather(t_idx, train_tab)                # [M, 3]
    pts2d = train_m[:, :2]
    depth_curr = torch.where(sel_valid, train_m[:, 2], 0.0)
    pts3d_obs = unproject(intr, pts2d, depth_curr)
    mark("match", rgb)

    # --- PnP-RANSAC -----------------------------------------------------------
    pnp = ransac_pnp(pts3d_m, pts2d, sel_valid, intr, cfg.pnp, sampler,
                     points3d_obs=pts3d_obs, obs_valid=depth_curr > 0,
                     valid_packed=True)
    success = pnp.success & attempted

    # inlier ratio over ALL ratio-test matches, not only the top M
    uv_all, z_all = project(intr, pnp.T_cw.apply(pts3d))
    uv_obs_all = incidence_gather(match.best_idx.to(torch.int64), feats.xy)
    err2_all = torch.sum((uv_all - uv_obs_all) ** 2, dim=-1)
    thr2 = cfg.pnp.reproj_threshold * cfg.pnp.reproj_threshold
    inl_all = (err2_all < thr2) & (z_all > 0) & match.is_match
    num_inliers_all = torch.sum(inl_all.to(torch.int32))
    ratio_all = num_inliers_all.to(torch.float32) / torch.clamp(
        num_matches.to(torch.float32), min=1.0)
    mark("pnp", rgb)

    last_kf_pose = SE3(take_row(m.kf_q, slot), take_row(m.kf_t, slot))
    if NK == 1:
        # reference chaining: T = kf.pose * T_cw^-1
        new_pose = last_kf_pose.compose(pnp.T_cw.inverse()).normalize()
    else:
        # world-frame solve: the camera pose is T_cw^-1 directly
        new_pose = pnp.T_cw.inverse().normalize()
    pose = SE3(torch.where(success, new_pose.q, state.pose_q),
               torch.where(success, new_pose.t, state.pose_t))

    # --- keyframe policy: the frame counter advances on attempted frames ----
    frames_since = state.frames_since_kf + attempted.to(torch.int32)
    ratio_for_policy = torch.where(success, ratio_all, 0.0)
    add_kf = kf_policy.should_add_keyframe(
        pose, last_kf_pose, frames_since, ratio_for_policy, cfg.policy) & attempted
    do_insert = empty | add_kf

    # --- insertion + landmark fusion (masked; no branch) ---------------------
    # fusion uses the matches against the previous-last keyframe only: the
    # first F rows of the bank
    fuse = MatchResult(*(f[:feats.capacity] for f in match))
    if defer_insert:
        pending = PendingInsert(
            do=do_insert, fresh=empty, pose_q=pose.q, pose_t=pose.t,
            kp_xy=feats.xy, kp_depth=depth_kp, kp_desc=feats.desc,
            kp_valid=feats.valid, fuse_idx=fuse.best_idx,
            fuse_ok=fuse.is_match)
        new_map = m
    else:
        new_map = insert_keyframe(m, feats, depth_kp, pose, do=do_insert)
        new_map = create_map_points(new_map, fuse, intr.fx, intr.fy,
                                    intr.cx, intr.cy, do=do_insert & ~empty)

    a_slot = new_map.last_slot()
    new_state = TrackState(
        map=new_map, pose_q=pose.q, pose_t=pose.t,
        frames_since_kf=torch.where(add_kf, 0, frames_since).to(torch.int32),
        frame_count=state.frame_count + 1,
    )
    out = TrackOutput(
        pose_q=pose.q, pose_t=pose.t, success=success, added_kf=do_insert,
        inlier_ratio=ratio_for_policy, num_matches=num_matches,
        num_inliers=num_inliers_all, num_features=feats.count(),
        anchor_id=new_map.num_kf - 1,
        anchor_q=take_row(new_map.kf_q, a_slot),
        anchor_t=take_row(new_map.kf_t, a_slot),
    )
    mark("map", rgb)
    if defer_insert:
        return new_state, out, pending
    return new_state, out


def track_step_batched(state: TrackState, rgb: torch.Tensor,
                       depth: torch.Tensor, mask: Optional[torch.Tensor],
                       intr: Intrinsics, cfg, sampler: Sampler,
                       defer_insert: bool = False):
    """``track_step`` for S streams at once: a state whose every tensor
    has a leading stream axis (``parallel.multistream.
    batched_init_state``), rgb [S, H, W, 3] uint8, depth [S, H, W] int32,
    mask [S, H, W] or None -> (new state, TrackOutput [S, ...]) and, with
    ``defer_insert``, the S streams' ``PendingInsert``. ``sampler`` is a
    batched sampler (``hash_sampler`` of a counter [S]). The body is
    ``track_step``'s, stage for stage."""
    m = state.map
    Sn = m.num_kf.shape[0]
    dev = m.num_kf.device
    mark(None, rgb)
    empty = m.is_empty()                                        # [S]
    feats, depth_kp = extract_frame(rgb, depth, mask, intr, cfg,
                                    batched=True)
    mark("frontend", rgb)

    # --- match against the last keyframe(s) ----------------------------------
    slot = m.last_slot()                                        # [S]
    NK = max(1, int(cfg.track_keyframes))
    if NK == 1:
        q_desc = take_rows(m.kf_desc, slot)
        q_valid = take_rows(m.kf_kp_valid, slot) & ~empty[:, None]
        pts3d = unproject(intr, take_rows(m.kf_kp_xy, slot),
                          take_rows(m.kf_kp_depth, slot))
    else:
        # each stream's last NK keyframes, newest first: one gather of
        # the S x NK slots
        ids = m.num_kf[:, None] - 1 - torch.arange(NK, dtype=torch.int32,
                                                   device=dev)
        kslots = torch.remainder(torch.clamp(ids, min=0), m.capacity_kf)
        flat = kslots.to(torch.int64) + (
            torch.arange(Sn, device=dev)[:, None] * m.capacity_kf)

        def bank(arr):                                      # [S, NK, ...]
            rows = arr.reshape((-1,) + arr.shape[2:]).index_select(
                0, flat.reshape(-1))
            return rows.reshape((Sn, NK) + arr.shape[2:])

        q_desc = bank(m.kf_desc).reshape(Sn, -1, m.kf_desc.shape[-1])
        q_valid = ((bank(m.kf_kp_valid) & (ids >= 0)[..., None]).reshape(
            Sn, -1) & ~empty[:, None])
        p_cam = unproject(intr, bank(m.kf_kp_xy), bank(m.kf_kp_depth))
        kf_T = SE3(bank(m.kf_q)[:, :, None, :], bank(m.kf_t)[:, :, None, :])
        pts3d = kf_T.apply(p_cam).reshape(Sn, -1, 3)
    match = knn2_ratio_match(q_desc, q_valid, feats.desc, feats.valid,
                             cfg.matcher.ratio,
                             cross_check=cfg.matcher.cross_check)
    num_matches = torch.sum(match.is_match.to(torch.int32), dim=-1)
    attempted = (num_matches >= cfg.pnp.min_points) & ~empty

    # --- compaction: the top-M matches by Hamming distance, packed first ----
    M = min(cfg.pnp.max_correspondences, q_desc.shape[1])
    score = torch.where(match.is_match, match.best_dist.to(torch.float32),
                        torch.inf)
    _, cidx = orb.topk_stable(-score, M)                        # [S, M]
    sel_valid = torch.gather(match.is_match, 1, cidx)
    pts3d_m = incidence_gather(cidx, pts3d)                     # [S, M, 3]
    t_idx = torch.gather(match.best_idx, 1, cidx).to(torch.int64)
    train_tab = torch.cat([feats.xy, depth_kp[..., None]], dim=-1)
    train_m = incidence_gather(t_idx, train_tab)                # [S, M, 3]
    pts2d = train_m[..., :2]
    depth_curr = torch.where(sel_valid, train_m[..., 2], 0.0)
    pts3d_obs = unproject(intr, pts2d, depth_curr)
    mark("match", rgb)

    # --- PnP-RANSAC -----------------------------------------------------------
    pnp = ransac_pnp_batched(pts3d_m, pts2d, sel_valid, intr, cfg.pnp,
                             sampler, points3d_obs=pts3d_obs,
                             obs_valid=depth_curr > 0)
    success = pnp.success & attempted

    # inlier ratio over ALL ratio-test matches, not only the top M
    T_cw = SE3(pnp.T_cw.q[:, None], pnp.T_cw.t[:, None])
    uv_all, z_all = project(intr, T_cw.apply(pts3d))
    uv_obs_all = incidence_gather(match.best_idx.to(torch.int64), feats.xy)
    err2_all = torch.sum((uv_all - uv_obs_all) ** 2, dim=-1)
    thr2 = cfg.pnp.reproj_threshold * cfg.pnp.reproj_threshold
    inl_all = (err2_all < thr2) & (z_all > 0) & match.is_match
    num_inliers_all = torch.sum(inl_all.to(torch.int32), dim=-1)
    ratio_all = num_inliers_all.to(torch.float32) / torch.clamp(
        num_matches.to(torch.float32), min=1.0)
    mark("pnp", rgb)

    last_kf_pose = SE3(take_rows(m.kf_q, slot), take_rows(m.kf_t, slot))
    if NK == 1:
        # reference chaining: T = kf.pose * T_cw^-1
        new_pose = last_kf_pose.compose(pnp.T_cw.inverse()).normalize()
    else:
        # world-frame solve: the camera pose is T_cw^-1 directly
        new_pose = pnp.T_cw.inverse().normalize()
    ok = success[:, None]
    pose = SE3(torch.where(ok, new_pose.q, state.pose_q),
               torch.where(ok, new_pose.t, state.pose_t))

    # --- keyframe policy: the frame counter advances on attempted frames ----
    frames_since = state.frames_since_kf + attempted.to(torch.int32)
    ratio_for_policy = torch.where(success, ratio_all, 0.0)
    add_kf = kf_policy.should_add_keyframe(
        pose, last_kf_pose, frames_since, ratio_for_policy, cfg.policy) & attempted
    do_insert = empty | add_kf

    # --- insertion + landmark fusion (masked; no branch) ---------------------
    # fusion uses the matches against the previous-last keyframe only: the
    # first F rows of the bank
    fuse = MatchResult(*(f[:, :feats.capacity] for f in match))
    if defer_insert:
        pending = PendingInsert(
            do=do_insert, fresh=empty, pose_q=pose.q, pose_t=pose.t,
            kp_xy=feats.xy, kp_depth=depth_kp, kp_desc=feats.desc,
            kp_valid=feats.valid, fuse_idx=fuse.best_idx,
            fuse_ok=fuse.is_match)
        new_map = m
    else:
        new_map = insert_keyframe_batched(m, feats, depth_kp, pose,
                                          do=do_insert)
        new_map = create_map_points_batched(new_map, fuse, intr.fx, intr.fy,
                                            intr.cx, intr.cy,
                                            do=do_insert & ~empty)

    a_slot = new_map.last_slot()
    new_state = TrackState(
        map=new_map, pose_q=pose.q, pose_t=pose.t,
        frames_since_kf=torch.where(add_kf, 0, frames_since).to(torch.int32),
        frame_count=state.frame_count + 1,
    )
    out = TrackOutput(
        pose_q=pose.q, pose_t=pose.t, success=success, added_kf=do_insert,
        inlier_ratio=ratio_for_policy, num_matches=num_matches,
        num_inliers=num_inliers_all, num_features=feats.count(),
        anchor_id=new_map.num_kf - 1,
        anchor_q=take_rows(new_map.kf_q, a_slot),
        anchor_t=take_rows(new_map.kf_t, a_slot),
    )
    mark("map", rgb)
    if defer_insert:
        return new_state, out, pending
    return new_state, out


def make_track_step(cfg, intr: Intrinsics, use_mask: bool = True,
                    seed: int = 0, sampler_for_frame=None):
    """``step(state, rgb, depth, mask=None) -> (state, TrackOutput)``.

    Each frame's minimal sets come from ``hash_sampler(seed,
    state.frame_count)``, on the device and without a host read;
    ``sampler_for_frame(frame_count)`` replaces that sampler with the
    frame number read on the host (tests inject the reference's index
    sets this way)."""
    def step(state, rgb, depth, mask=None):
        if sampler_for_frame is not None:
            sampler = sampler_for_frame(int(state.frame_count))
        else:
            sampler = hash_sampler(seed, state.frame_count)
        return track_step(state, rgb, depth, mask if use_mask else None,
                          intr, cfg, sampler)
    return step


def track_step_into(step, state, rgb, depth, mask=None) -> torch.Tensor:
    """``step`` (``make_track_step``'s) on ``state``, with the new state
    written into ``state``'s tensors and the outputs packed into one
    [1, OUTPUT_WIDTH] float64 row (``output_rows``)."""
    new, out = step(state, rgb, depth, mask)
    assign_state(state, new)
    return output_rows(TrackOutput(*(f[None] for f in out)))
