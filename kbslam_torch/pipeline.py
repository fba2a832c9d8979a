"""The per-frame tracking step (port of kbslam/pipeline.py).

extract ORB -> match against the last keyframe -> PnP-RANSAC -> pose ->
keyframe policy -> masked keyframe insertion and landmark creation, as
eager torch on one device. The step makes no host round trip: every
decision (success, insertion) stays a device tensor and gates the map
writes by masking.

Not ported yet (they raise ``NotImplementedError``): tracking against a
bank of several keyframes (``track_keyframes > 1``) and deferred
insertion (``defer_insert``) — ROADMAP.md, "Slice A, left for later".
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from kbslam_torch.frontend import orb
from kbslam_torch.geom.camera import Intrinsics, depth_at, project, unproject
from kbslam_torch.geom.se3 import SE3
from kbslam_torch.mapping import policy as kf_policy
from kbslam_torch.mapping.state import (MapState, create_map_points,
                                        empty_map, insert_keyframe, take_row)
from kbslam_torch.matching.hamming import knn2_ratio_match
from kbslam_torch.ops.incidence import incidence_gather
from kbslam_torch.pnp.ransac import Sampler, generator_sampler, ransac_pnp

_LATER = "is not ported yet (ROADMAP.md, Slice A, left for later)"


class TrackState(NamedTuple):
    map: MapState
    pose_q: torch.Tensor            # current camera pose T_wc
    pose_t: torch.Tensor
    frames_since_kf: torch.Tensor   # [] int32
    # a host int: it seeds the frame's RANSAC generator, so keeping it on
    # the host saves a device read per frame
    frame_count: int

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


def init_state(cfg, device) -> TrackState:
    return TrackState(
        map=empty_map(cfg.map, cfg.orb, device),
        pose_q=torch.tensor([1.0, 0, 0, 0], device=device),
        pose_t=torch.zeros(3, device=device),
        frames_since_kf=torch.zeros((), dtype=torch.int32, device=device),
        frame_count=0,
    )


def frame_generator(seed: int, frame_count: int,
                    device: torch.device) -> torch.Generator:
    """The RANSAC generator of one frame, seeded from (seed, frame)."""
    s = int(np.random.SeedSequence([seed, frame_count]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(s)


def _pool3x3(x: torch.Tensor, sign: float) -> torch.Tensor:
    """3x3 'SAME' max (sign=1) or min (sign=-1) of [H, W] float32."""
    return sign * F.max_pool2d((sign * x)[None, None], 3, stride=1,
                               padding=1)[0, 0]


def extract_frame(rgb, depth, mask, intr: Intrinsics, cfg):
    """ORB under the mask, keypoint depth with the occlusion-rim gate,
    and one-shot undistortion. depth is [H, W] int32 raw units."""
    feats = orb.extract(rgb, mask, cfg.orb)
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
    draws RANSAC's minimal sets (see kbslam_torch.pnp.ransac)."""
    if int(cfg.track_keyframes) > 1:
        raise NotImplementedError(f"track_keyframes > 1 {_LATER}")
    if defer_insert:
        raise NotImplementedError(f"defer_insert {_LATER}")
    m = state.map
    empty = m.is_empty()
    feats, depth_kp = extract_frame(rgb, depth, mask, intr, cfg)

    # --- match against the last keyframe -----------------------------------
    slot = m.last_slot()
    q_desc = take_row(m.kf_desc, slot)
    q_valid = take_row(m.kf_kp_valid, slot) & ~empty
    pts3d = unproject(intr, take_row(m.kf_kp_xy, slot),
                      take_row(m.kf_kp_depth, slot))
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

    # reference chaining: T = kf.pose * T_cw^-1
    last_kf_pose = SE3(take_row(m.kf_q, slot), take_row(m.kf_t, slot))
    new_pose = last_kf_pose.compose(pnp.T_cw.inverse()).normalize()
    pose = SE3(torch.where(success, new_pose.q, state.pose_q),
               torch.where(success, new_pose.t, state.pose_t))

    # --- keyframe policy: the frame counter advances on attempted frames ----
    frames_since = state.frames_since_kf + attempted.to(torch.int32)
    ratio_for_policy = torch.where(success, ratio_all, 0.0)
    add_kf = kf_policy.should_add_keyframe(
        pose, last_kf_pose, frames_since, ratio_for_policy, cfg.policy) & attempted
    do_insert = empty | add_kf

    # --- insertion + landmark fusion (masked; no branch) ---------------------
    new_map = insert_keyframe(m, feats, depth_kp, pose, do=do_insert)
    new_map = create_map_points(new_map, match, intr.fx, intr.fy, intr.cx,
                                intr.cy, do=do_insert & ~empty)

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
    return new_state, out


def make_track_step(cfg, intr: Intrinsics, use_mask: bool = True,
                    seed: int = 0, sampler_for_frame=None):
    """``step(state, rgb, depth, mask=None) -> (state, TrackOutput)``.

    Each frame's minimal sets come from ``frame_generator(seed,
    frame_count)``; ``sampler_for_frame(frame_count)`` replaces that
    sampler (tests inject the reference's index sets this way)."""
    def step(state, rgb, depth, mask=None):
        if sampler_for_frame is not None:
            sampler = sampler_for_frame(state.frame_count)
        else:
            sampler = generator_sampler(
                frame_generator(seed, state.frame_count, rgb.device))
        return track_step(state, rgb, depth, mask if use_mask else None,
                          intr, cfg, sampler)
    return step
