"""Keyframe insertion policy (port of kbslam/mapping/policy.py).

Insert iff at least ``min_frame_gap`` frames passed since the last
keyframe AND (translation > 0.5 m OR rotation > 5 deg OR PnP inlier
ratio < 0.4) relative to it.
"""
from __future__ import annotations

import math

import torch

from slambench.reference.geom.se3 import SE3


def should_add_keyframe(pose: SE3, last_kf_pose: SE3,
                        frames_since_kf: torch.Tensor,
                        inlier_ratio: torch.Tensor, cfg) -> torch.Tensor:
    rel = last_kf_pose.inverse().compose(pose)
    translation = rel.translation_norm()
    angle_deg = rel.rotation_angle() * (180.0 / math.pi)
    trigger = ((translation > cfg.translation_threshold)
               | (angle_deg > cfg.rotation_threshold_deg)
               | (inlier_ratio < cfg.min_inlier_ratio))
    return (frames_since_kf >= cfg.min_frame_gap) & trigger
