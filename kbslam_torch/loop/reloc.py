"""Relocalization after tracking loss.

Port of kbslam/loop/reloc.py. One attempt, with no host round trip:

1. extract the frame's features (``pipeline.extract_frame``, and so the
   describe kernel on the card);
2. score the frame's word signature against every keyframe of the ring
   (loop/detect.py);
3. match the best keyframe mutual-best and solve PnP-RANSAC on its
   depth-unprojected points: the tracking step's last-keyframe path with
   the slot overridden;
4. on success insert the frame as a new keyframe chained off the matched
   one (pose T_match T_cw^-1; landmark fusion against the matched
   keyframe's rows), so tracking resumes against a fresh anchor.

Failure is a masked no-op: map and pose come back unchanged. As the
tracking step, the attempt writes some map tensors in place and returns
new ones for others.

One fault of the reference is not copied by the shells: a frame whose
tracking failed may still insert a keyframe (the policy sees a zero
inlier ratio), at the held, wrong pose; place recognition then finds
that keyframe, at worst the probed frame itself with a score of 1, and
re-anchors the camera at the wrong pose. ``exclude_from_id`` masks the
keyframes with ids from it on out of place recognition; the shells pass
the insertion count of their last tracked frame. ``None`` (the
default) keeps the reference's behaviour.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from kbslam_torch.geom.camera import Intrinsics, unproject
from kbslam_torch.geom.se3 import SE3
from kbslam_torch.loop.detect import (kf_signatures, normalized_histogram,
                                      word_ids)
from kbslam_torch.mapping.state import (create_map_points, insert_keyframe,
                                        take_row)
from kbslam_torch.matching.hamming import knn2_ratio_match
from kbslam_torch.pipeline import TrackState, extract_frame
from kbslam_torch.pnp.ransac import Sampler, hash_sampler, ransac_pnp

# the attempt's minimal sets: frame_count + FRAME_OFFSET as the counter,
# apart from the tracking step's draws of the same frame
FRAME_OFFSET = 1 << 20


class RelocResult(NamedTuple):
    success: torch.Tensor      # bool — relocalized (and keyframe inserted)
    slot: torch.Tensor         # int32 matched keyframe ring slot
    score: torch.Tensor        # float32 signature similarity
    num_inliers: torch.Tensor
    pose_q: torch.Tensor       # [4] recovered T_wc (unchanged on failure)
    pose_t: torch.Tensor       # [3]


def reloc_step(state: TrackState, rgb, depth, mask, sampler: Sampler,
               intr: Intrinsics, cfg, *, word_bits: int = 10,
               score_min: float = 0.5, min_inliers: int = 40,
               exclude_from_id=None):
    m = state.map
    feats, depth_kp = extract_frame(rgb, depth, mask, intr, cfg)

    # --- place recognition: the frame's signature against the ring -------
    fsig = normalized_histogram(word_ids(feats.desc, word_bits), feats.valid,
                                word_bits)
    sigs = kf_signatures(m.kf_desc, m.kf_kp_valid, word_bits)
    live = m.kf_id >= 0
    if exclude_from_id is not None:
        live = live & (m.kf_id < exclude_from_id)
    scores = torch.where(live, sigs @ fsig, -1.0)
    slot = torch.argmax(scores).to(torch.int32)     # the first maximum
    score = take_row(scores, slot)
    found = score >= score_min

    # --- verify and solve: the last-keyframe path, slot overridden -------
    q_valid = (take_row(m.kf_kp_valid, slot)
               & (take_row(m.kf_id, slot) >= 0))
    pts3d = unproject(intr, take_row(m.kf_kp_xy, slot),
                      take_row(m.kf_kp_depth, slot))
    match = knn2_ratio_match(take_row(m.kf_desc, slot), q_valid, feats.desc,
                             feats.valid, cfg.matcher.ratio, cross_check=True)
    idx = match.best_idx.to(torch.int64)
    pts2d = feats.xy.index_select(0, idx)
    depth_t = torch.where(match.is_match, depth_kp.index_select(0, idx), 0.0)
    pts3d_obs = unproject(intr, pts2d, depth_t)
    pnp = ransac_pnp(pts3d, pts2d, match.is_match, intr, cfg.pnp, sampler,
                     points3d_obs=pts3d_obs, obs_valid=depth_t > 0)
    success = found & pnp.success & (pnp.num_inliers >= min_inliers)
    # Eviction guard: with a full ring the insertion below overwrites slot
    # num_kf % capacity; if that is the matched keyframe, fusion would
    # bind the new frame's rows to themselves. Left to the next attempt.
    evict = ((m.num_kf >= m.capacity_kf)
             & (slot == torch.remainder(m.num_kf, m.capacity_kf)))
    success = success & ~evict

    kf_pose = SE3(take_row(m.kf_q, slot), take_row(m.kf_t, slot))
    new_pose = kf_pose.compose(pnp.T_cw.inverse()).normalize()
    pose_q = torch.where(success, new_pose.q, state.pose_q)
    pose_t = torch.where(success, new_pose.t, state.pose_t)

    # --- re-anchor: the frame becomes a keyframe on success --------------
    new_map = insert_keyframe(m, feats, depth_kp, SE3(pose_q, pose_t),
                              do=success)
    # fuse against the matched keyframe's rows. The reference sends a
    # failed attempt's fusion to slot capacity (out of range, no write);
    # here ``do`` masks every write, so the slot itself is passed
    new_map = create_map_points(new_map, match, intr.fx, intr.fy, intr.cx,
                                intr.cy, do=success, prev_slot=slot)

    new_state = TrackState(
        map=new_map, pose_q=pose_q, pose_t=pose_t,
        frames_since_kf=torch.where(success, 0, state.frames_since_kf
                                    ).to(torch.int32),
        frame_count=state.frame_count,  # the track step already counted
    )
    return new_state, RelocResult(success=success, slot=slot, score=score,
                                  num_inliers=pnp.num_inliers,
                                  pose_q=pose_q, pose_t=pose_t)


def make_reloc_step(cfg, intr: Intrinsics, use_mask: bool = True, *,
                    word_bits: int = 10, score_min: float = 0.5,
                    min_inliers: int = 40, seed: int = 0,
                    sampler_for_frame=None):
    """``step(state, rgb, depth, mask=None, exclude_from_id=None) ->
    (state, RelocResult)``; ``exclude_from_id`` is an int (see the
    module docstring).

    The minimal sets come from ``hash_sampler(seed, frame_count +
    FRAME_OFFSET)`` on the device; ``sampler_for_frame(frame_count)``
    replaces that sampler with the frame number read on the host (tests
    inject the reference's sets)."""
    def step(state, rgb, depth, mask=None, exclude_from_id=None):
        if sampler_for_frame is not None:
            sampler = sampler_for_frame(int(state.frame_count))
        else:
            sampler = hash_sampler(seed, state.frame_count + FRAME_OFFSET)
        if exclude_from_id is not None:     # a fill, not a host copy
            exclude_from_id = torch.full((), exclude_from_id,
                                         dtype=torch.int32,
                                         device=state.frame_count.device)
        return reloc_step(state, rgb, depth, mask if use_mask else None,
                          sampler, intr, cfg, word_bits=word_bits,
                          score_min=score_min, min_inliers=min_inliers,
                          exclude_from_id=exclude_from_id)
    return step
