"""Dense Harris corner response (Sobel gradients, 7x7 box-summed second
moments), used to rank FAST corners. Port of kbslam/frontend/harris.py.
"""
from __future__ import annotations

import torch

from slambench.reference.frontend.image import box_filter, shift2d


def sobel_gradients(img: torch.Tensor):
    """3x3 Sobel dx, dy with zero borders."""
    def s(dy, dx):
        return shift2d(img, dy, dx)

    gx = (s(-1, 1) - s(-1, -1)) + 2.0 * (s(0, 1) - s(0, -1)) + (s(1, 1) - s(1, -1))
    gy = (s(1, -1) - s(-1, -1)) + 2.0 * (s(1, 0) - s(-1, 0)) + (s(1, 1) - s(-1, 1))
    return gx, gy


def harris_response(img: torch.Tensor, block_size: int = 7,
                    k: float = 0.04) -> torch.Tensor:
    gx, gy = sobel_gradients(img)
    ixx = box_filter(gx * gx, block_size)
    iyy = box_filter(gy * gy, block_size)
    ixy = box_filter(gx * gy, block_size)
    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    # scale normalization keeps values in a sane float32 range
    return (det - k * tr * tr) * (1.0 / (block_size * block_size * 255.0) ** 2)
