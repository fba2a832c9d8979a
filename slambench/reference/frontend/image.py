"""Image primitives: grayscale, resize pyramid, separable Gaussian blur.

Port of kbslam/frontend/image.py. Functions act on the last two axes;
leading axes are batched.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

GRAY_WEIGHTS = (0.299, 0.587, 0.114)

# Constant tensors are built once per device and cached: a copy from the
# host waits for the device to drain its queue, so the step makes none.


@functools.lru_cache(maxsize=8)
def _gray_weights(device: torch.device) -> torch.Tensor:
    return torch.tensor(GRAY_WEIGHTS, dtype=torch.float32, device=device)


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] uint8/float RGB -> [..., H, W] float32 BT.601 luma."""
    return rgb.to(torch.float32) @ _gray_weights(rgb.device)


def pyramid_sizes(h: int, w: int, num_levels: int,
                  scale: float) -> List[Tuple[int, int]]:
    """Per-level (h, w): cv::ORB's cvRound(size / scale^level)."""
    out = []
    for lv in range(num_levels):
        s = scale ** lv
        out.append((int(round(h / s)), int(round(w / s))))
    return out


@functools.lru_cache(maxsize=64)
def _linear_weights(m: int, n: int) -> np.ndarray:
    """[m, n] float32 weights of an m -> n linear resize with half-pixel
    centres and no antialiasing: the matrix ``jax.image.resize``
    contracts with (``compute_weight_mat`` with the triangle kernel)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n / m))
    sample_f = (np.arange(n, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(m, dtype=f32)[:, None])
    weights = np.maximum(f32(0), f32(1) - x)
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    ok = np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps)
    weights = np.where(ok, weights / np.where(total != 0, total, f32(1)),
                       f32(0))
    inside = (sample_f >= f32(-0.5)) & (sample_f <= f32(m - 0.5))
    return np.where(inside[None, :], weights, f32(0)).astype(f32)


@functools.lru_cache(maxsize=64)
def _linear_weights_on(m: int, n: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_linear_weights(m, n)).to(device)


def resize_bilinear(img: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize [..., H, W] -> [..., *shape], half-pixel centres,
    as the two weight-matrix contractions ``jax.image.resize(method=
    "linear", antialias=False)`` performs. With leading axes the second
    product is one GEMM over every image's rows; on the CPU each image's
    rows come out as its own product gives them
    (tests/test_torch_multistream_batched.py)."""
    h, w = img.shape[-2:]
    out = img
    if shape[0] != h:
        out = _linear_weights_on(h, shape[0], img.device).T @ out
    if shape[1] != w:
        out = out @ _linear_weights_on(w, shape[1], img.device)
    return out


def build_pyramid(gray: torch.Tensor, num_levels: int,
                  scale: float) -> List[torch.Tensor]:
    """Levels [..., h_l, w_l] of [..., H, W] images."""
    h, w = gray.shape[-2:]
    sizes = pyramid_sizes(h, w, num_levels, scale)
    levels = [gray]
    for lv in range(1, num_levels):
        # each level is resized from the previous one, as cv::ORB does
        levels.append(resize_bilinear(levels[-1], sizes[lv]))
    return levels


@functools.lru_cache(maxsize=8)
def _gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _gaussian_kernel_on(ksize: int, sigma: float,
                        device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_gaussian_kernel_1d(ksize, sigma)).to(device)


def _as_3d(img: torch.Tensor) -> torch.Tensor:
    return img.reshape((-1,) + tuple(img.shape[-2:]))


def gaussian_blur(img: torch.Tensor, ksize: int = 7,
                  sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur with edge replication (cv::ORB blurs each
    level, 7x7 sigma 2, before BRIEF sampling)."""
    k = _gaussian_kernel_on(ksize, sigma, img.device)
    r = ksize // 2
    h, w = img.shape[-2:]
    padded = F.pad(_as_3d(img), (0, 0, r, r), mode="replicate")
    rows = sum(padded[..., i:i + h, :] * k[i] for i in range(ksize))
    padded = F.pad(rows, (r, r, 0, 0), mode="replicate")
    cols = sum(padded[..., :, i:i + w] * k[i] for i in range(ksize))
    return cols.reshape(img.shape)


def box_filter(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """Sum over a ksize x ksize window (zero padded), via shifted adds."""
    r = ksize // 2
    h, w = img.shape[-2:]
    padded = F.pad(img, (0, 0, r, r))
    rows = sum(padded[..., i:i + h, :] for i in range(ksize))
    padded = F.pad(rows, (r, r, 0, 0))
    return sum(padded[..., :, i:i + w] for i in range(ksize))


def shift2d(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[..., y, x] = img[..., y + dy, x + dx], zero fill (|d| <= 3)."""
    h, w = img.shape[-2:]
    padded = F.pad(img, (3, 3, 3, 3))
    return padded[..., 3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
