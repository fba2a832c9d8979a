"""Batched Kabsch 3D-3D minimal solver (port of kbslam/pnp/kabsch.py).

The rotation is the Newton polar factor of the cross-covariance, not an
SVD, as in the reference; reflection-degenerate sets come out improper
and score no inliers downstream.
"""
from __future__ import annotations

import torch

from slambench.reference.geom.rotation import polar_rotation


def solve_kabsch(src: torch.Tensor, dst: torch.Tensor, weights=None):
    """Least-squares rigid transform dst ~= R @ src + t for src, dst
    [..., n, 3] (weights optional [..., n]) -> (R [..., 3, 3], t [..., 3])."""
    w = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device) \
        if weights is None else weights
    wsum = torch.sum(w, dim=-1, keepdim=True) + 1e-12
    cs = torch.sum(src * w[..., None], dim=-2) / wsum
    cd = torch.sum(dst * w[..., None], dim=-2) / wsum
    s0 = src - cs[..., None, :]
    d0 = dst - cd[..., None, :]
    H = torch.einsum("...ni,...nj,...n->...ij", s0, d0, w)
    R = polar_rotation(H.transpose(-1, -2))
    t = cd - torch.einsum("...ij,...j->...i", R, cs)
    return R, t
