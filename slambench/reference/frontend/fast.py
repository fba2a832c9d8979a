"""FAST-9/16 corner score map, 3x3 non-maximum suppression, border mask.

Port of kbslam/frontend/fast.py: the 16 Bresenham-circle shifts are
whole-image tensors, and the contiguous-arc test is a min/max over the
16 rotated windows of length 9.
"""
from __future__ import annotations

import functools

import torch

from slambench.reference.frontend.image import shift2d

# Bresenham circle of radius 3, clockwise from 12 o'clock: (dy, dx)
CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC_LEN = 9  # FAST-9


def _sliding_windows(arrs, L, op):
    """op-reduction over every length-L window of the list (van Herk:
    blockwise forward/backward prefix passes)."""
    n = len(arrs)
    Fw = [None] * n
    Bw = [None] * n
    for i in range(n):
        Fw[i] = arrs[i] if i % L == 0 else op(Fw[i - 1], arrs[i])
    for i in reversed(range(n)):
        last = (i % L == L - 1) or (i == n - 1)
        Bw[i] = arrs[i] if last else op(arrs[i], Bw[i + 1])
    return [op(Bw[s], Fw[s + L - 1]) for s in range(n - L + 1)]


def fast_score_map(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """Corner response [H, W]: the best arc margin, 0 where not a FAST-9
    corner."""
    diff = [shift2d(img, dy, dx) - img for (dy, dx) in CIRCLE]
    ext = diff + diff[: ARC_LEN - 1]                 # circular, 24 entries
    bright_score = _sliding_windows(ext, ARC_LEN, torch.minimum)
    dark_score = _sliding_windows(ext, ARC_LEN, torch.maximum)
    bright = functools.reduce(torch.maximum, bright_score)
    dark = -functools.reduce(torch.minimum, dark_score)
    score = torch.maximum(bright, dark)
    return torch.where(score > threshold, score, 0.0)


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep only strict 3x3 local maxima (zero elsewhere); ties go to the
    lexicographically earlier pixel."""
    is_max = torch.ones_like(score, dtype=torch.bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                is_max &= score >= shift2d(score, dy, dx)
    for dy, dx in ((0, 1), (1, -1), (1, 0), (1, 1)):
        is_max &= score > shift2d(score, dy, dx)
    return torch.where(is_max, score, 0.0)


def border_mask(h: int, w: int, border: int, device=None) -> torch.Tensor:
    """True inside the detection region (edge_threshold=31)."""
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    return (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
