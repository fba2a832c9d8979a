"""Rotated BRIEF (rBRIEF) 256-bit descriptors and the patches they read.

Port of kbslam/frontend/brief.py. The sampling pattern is the port's
copy of the reference's ``brief_pattern_learned.npy`` (beside this
file), read with the same clip; the 30 rotated selection matrices and
the intensity-centroid weights are built from it the same way.

The tracking step runs these stages fused in one CUDA kernel
(``kbslam_torch/ops/describe.py``); the functions here are its plain
composition and the parity surface against the reference.
"""
from __future__ import annotations

import functools
import math
from pathlib import Path

import numpy as np
import torch

from slambench.reference.ops import patches as patch_ops

DESC_BITS = 256
PATTERN_CLIP = 13  # keeps rotated samples within the 31-px edge margin
PATTERN_FILE = Path(__file__).resolve().parent / "brief_pattern_learned.npy"

_PATCH_R = 20          # covers the rotated pattern: 13*sqrt(2) + rounding
_PATCH_S = 2 * _PATCH_R
N_ANGLE_BINS = 30      # cv::ORB quantizes orientation to 30 steps of 12 deg


@functools.lru_cache(maxsize=1)
def brief_pattern() -> np.ndarray:
    """[256, 4] int32 (x1, y1, x2, y2) sampling offsets: the learned
    pattern when its file is present, else the deterministic Gaussian
    pattern (seed 42) of the reference."""
    if PATTERN_FILE.exists():
        pat = np.load(PATTERN_FILE).astype(np.int32)
        if pat.shape == (DESC_BITS, 4):
            return np.clip(pat, -PATTERN_CLIP, PATTERN_CLIP)
    rng = np.random.default_rng(42)
    pts = rng.normal(0.0, 31.0 / 5.0, size=(DESC_BITS, 4))
    return np.clip(np.round(pts), -PATTERN_CLIP, PATTERN_CLIP).astype(np.int32)


@functools.lru_cache(maxsize=1)
def _rotated_selection_matrices() -> np.ndarray:
    """[30, 256, S^2] int8: per angle bin, onehot(p2) - onehot(p1) over
    the flattened 40x40 patch (cv::ORB's per-bin rotated patterns)."""
    pat = brief_pattern().astype(np.float64)
    p1 = pat[:, :2]
    p2 = pat[:, 2:]
    S = _PATCH_S
    out = np.zeros((N_ANGLE_BINS, 256, S * S), np.int8)
    for b in range(N_ANGLE_BINS):
        th = 2.0 * np.pi * b / N_ANGLE_BINS
        c, s = np.cos(th), np.sin(th)
        R = np.array([[c, -s], [s, c]])
        for (pts, sign) in ((p1, -1), (p2, +1)):
            q = np.rint(pts @ R.T).astype(np.int64)
            idx = (q[:, 1] + _PATCH_R) * S + (q[:, 0] + _PATCH_R)
            out[b, np.arange(256), idx] += sign
    return out


@functools.lru_cache(maxsize=1)
def _used_selection_matrices():
    """(W_used [30*256, U] int8, used_cols [U] int64): the selection
    matrices restricted to the patch columns some bin references."""
    W = _rotated_selection_matrices().reshape(
        N_ANGLE_BINS * 256, _PATCH_S * _PATCH_S)
    used = np.flatnonzero(np.any(W != 0, axis=0))
    return np.ascontiguousarray(W[:, used]), used


@functools.lru_cache(maxsize=8)
def _selection_on(device: torch.device):
    """(W_used^T as float32 [U, 30*256], used_cols [U]) on ``device``."""
    W_used, used = _used_selection_matrices()
    Wt = torch.from_numpy(W_used.T.astype(np.float32)).contiguous()
    return Wt.to(device), torch.from_numpy(used).to(device)


@functools.lru_cache(maxsize=8)
def _ic_moment_vectors(radius: int, device: torch.device) -> torch.Tensor:
    """[S^2, 2] float32 x- and y-weighted disc weights over the flattened
    40x40 patch, for intensity-centroid orientation."""
    S = _PATCH_S
    ys, xs = np.mgrid[0:S, 0:S]
    dx = xs - _PATCH_R
    dy = ys - _PATCH_R
    disc = (dx * dx + dy * dy) <= radius * radius
    mv = np.stack([(dx * disc).reshape(-1), (dy * disc).reshape(-1)],
                  axis=-1).astype(np.float32)
    return torch.from_numpy(mv).to(device)


def patch_origins(level_dims: torch.Tensor, xy: torch.Tensor,
                  level: torch.Tensor):
    """(y0, x0) int32 [..., N]: the clamped top-left corner of each
    keypoint's 40x40 patch in its level. level_dims: [L, 2] int (h_l,
    w_l); xy: [..., N, 2] level-coordinate keypoints; level: [..., N]
    int."""
    base = torch.round(xy).to(torch.int32)
    hw = level_dims.to(torch.int32)[level.to(torch.int64)]
    # upper clamp floored at 0: a level smaller than the patch (tiny
    # frames, deep levels) would otherwise give a negative origin. Such
    # levels hold no valid keypoints (the 31-px border empties them).
    x_hi = torch.clamp(hw[..., 1] - _PATCH_S, min=0)
    y_hi = torch.clamp(hw[..., 0] - _PATCH_S, min=0)
    x0 = torch.minimum(torch.clamp(base[..., 0] - _PATCH_R, min=0), x_hi)
    y0 = torch.minimum(torch.clamp(base[..., 1] - _PATCH_R, min=0), y_hi)
    return y0.contiguous(), x0.contiguous()


def extract_patches(stacked: torch.Tensor, level_dims: torch.Tensor,
                    xy: torch.Tensor, level: torch.Tensor) -> torch.Tensor:
    """One 40x40 patch per keypoint, [N, S^2].

    stacked: [L, H0, W0] blurred pyramid (level l in its top-left
    [h_l, w_l] corner); level_dims, xy, level: as ``patch_origins``.

    The reference's ``precision`` argument selected the TPU kernel's
    matmul passes; it has no meaning here, because the CUDA kernel (and
    its CPU twin) copy the patch exactly.
    """
    n = xy.shape[0]
    y0, x0 = patch_origins(level_dims, xy, level)
    out = patch_ops.extract_patches(stacked.contiguous(),
                                    level.to(torch.int32).contiguous(),
                                    y0, x0, _PATCH_S)
    return out.reshape(n, _PATCH_S * _PATCH_S)


def ic_angles(patches: torch.Tensor, radius: int = 15) -> torch.Tensor:
    """Intensity-centroid orientation theta = atan2(m01, m10) from the
    blurred patches (one [N, S^2] x [S^2, 2] product)."""
    m = patches @ _ic_moment_vectors(radius, patches.device)
    return torch.atan2(m[:, 1], m[:, 0])


def bits_from_patches(patches: torch.Tensor,
                      angle: torch.Tensor) -> torch.Tensor:
    """rBRIEF bits [N, 256] uint8 in {0, 1}.

    Orientation is quantized to 30 bins. All bins evaluate as one
    [N, U] x [U, 30*256] product with the constant +-1 selection
    matrices; each keypoint then takes its bin's row. Operands are
    rounded through bfloat16 and the product is float32, as in the
    reference (kbslam/frontend/brief.py:193-197). Each selection row has
    one +1 and one -1, so I2 - I1 comes out exact in any summation
    order.
    """
    n = patches.shape[0]
    Wt, used = _selection_on(patches.device)
    pq = patches[:, used].to(torch.bfloat16).to(torch.float32)
    diff_all = (pq @ Wt).reshape(n, N_ANGLE_BINS, 256)    # I2 - I1 per bin
    diff = diff_all[torch.arange(n, device=patches.device), angle_bins(angle)]
    return (diff > 0).to(torch.uint8)


def angle_frac(angle: torch.Tensor) -> torch.Tensor:
    """The orientation in units of bins, [0, 30], float32."""
    two_pi = 2.0 * math.pi
    return torch.remainder(angle, two_pi) / two_pi * N_ANGLE_BINS


def angle_bins(angle: torch.Tensor) -> torch.Tensor:
    """The rotated pattern's bin of each angle, [N] int64 in [0, 30):
    round half to even (``torch.round``, like ``jnp.round``), then
    modulo 30."""
    return torch.remainder(torch.round(angle_frac(angle)).to(torch.int64),
                           N_ANGLE_BINS)


def pack_bits(desc: torch.Tensor) -> torch.Tensor:
    """[N, 256] {0,1} -> [N, 32] uint8 packed (LSB-first per byte)."""
    n = desc.shape[0]
    d = desc.reshape(n, 32, 8).to(torch.int32)
    weights = 1 << torch.arange(8, dtype=torch.int32, device=desc.device)
    return torch.sum(d * weights, dim=-1).to(torch.uint8)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """[N, 32] uint8 -> [N, 256] {0,1} uint8."""
    n = packed.shape[0]
    shifts = torch.arange(8, dtype=torch.int32, device=packed.device)
    bits = (packed[:, :, None].to(torch.int32) >> shifts) & 1
    return bits.reshape(n, 256).to(torch.uint8)
