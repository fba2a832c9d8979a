"""Keypoint description as plain torch, frozen for the benchmark's
reference: the patch gather, then ``brief.ic_angles`` and
``brief.bits_from_patches``. This is the twin the port's fused describe
kernel is held to; it runs on any device.
"""
from __future__ import annotations

import torch

from slambench.reference.frontend import brief
from slambench.reference.ops import patches as patch_ops

PATCH_SIZE = 40


def describe_keypoints_reference(stacked: torch.Tensor, level: torch.Tensor,
                                 y0: torch.Tensor, x0: torch.Tensor,
                                 radius: int = 15):
    """Plain torch twin of the kernel: (angle [..., N] float32, bits
    [..., N, 256] uint8). A [S, L, H, W] pyramid is described stream by
    stream (the CPU's vectorized atan2 rounds otherwise in a vector's
    tail, so a stream's angles would depend on its neighbours')."""
    if stacked.ndim == 4:
        parts = [describe_keypoints_reference(p, lv, y, x, radius)
                 for p, lv, y, x in zip(stacked, level, y0, x0)]
        return (torch.stack([a for a, _ in parts]),
                torch.stack([b for _, b in parts]))
    n = level.shape[0]
    patches = patch_ops.extract_patches_reference(
        stacked, level, y0, x0, PATCH_SIZE).reshape(n, PATCH_SIZE ** 2)
    angle = brief.ic_angles(patches, radius=radius)
    return angle, brief.bits_from_patches(patches, angle)


def describe_keypoints(stacked: torch.Tensor, level: torch.Tensor,
                       y0: torch.Tensor, x0: torch.Tensor, radius: int = 15):
    """(angle, bits) of the keypoints: ``describe_keypoints_reference``."""
    return describe_keypoints_reference(stacked, level, y0, x0, radius)
