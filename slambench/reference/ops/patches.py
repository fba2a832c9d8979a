"""The plain patch gather of the port's patch kernel, frozen for the
benchmark's reference: for every keypoint ``n`` the S x S window
``stacked[level[n], y0[n]:y0[n]+S, x0[n]:x0[n]+S]`` of the stacked
pyramid, with the origin clamped into the pyramid.
"""
from __future__ import annotations

import torch

PATCH_SIZE = 40


def extract_patches_reference(stacked: torch.Tensor, level: torch.Tensor,
                              y0: torch.Tensor, x0: torch.Tensor,
                              patch_size: int = PATCH_SIZE) -> torch.Tensor:
    """Plain torch twin of the kernel: [L, H, W] + [N] x 3 -> [N, S, S]."""
    L, H, W = stacked.shape
    S = patch_size
    lv = torch.clamp(level.to(torch.int64), 0, L - 1)
    y = torch.clamp(y0.to(torch.int64), 0, H - S)
    x = torch.clamp(x0.to(torch.int64), 0, W - S)
    r = torch.arange(S, device=stacked.device)
    rows = (lv * H + y)[:, None] + r                      # [N, S]
    cols = x[:, None] + r                                 # [N, S]
    flat = rows[:, :, None] * W + cols[:, None, :]        # [N, S, S]
    return stacked.reshape(-1)[flat]
