"""Fused keypoint description: the CUDA kernel and its plain twin.

The Hopper redesign of the TPU kernel ``extract_patches_pallas``
(kbslam/ops/pallas_patches.py:114-160) fused with the two stages that
read its patches, ``ic_angles`` and ``bits_from_patches``
(kbslam/frontend/brief.py:157-210). For every keypoint ``n`` with the
clamped patch origin ``(level[n], y0[n], x0[n])`` it returns

- ``angle[n]``: the intensity-centroid orientation of the 40x40 patch
  over the radius-``radius`` disc, float32 radians;
- ``bits[n]``: the 256 rotated-BRIEF bits of the pattern of the angle's
  bin, uint8 in {0, 1} (the ``Features.desc`` layout).

- A CUDA tensor goes to the hand-written kernel
  (kbslam_torch/csrc/describe.cu), which keeps each patch in shared
  memory and writes only the angles and bits, or the call raises.
- A CPU tensor goes to ``describe_keypoints_reference``: the patch copy
  of ``ops.patches``, then ``brief.ic_angles`` and
  ``brief.bits_from_patches``, which the tests hold against the JAX
  package.

The pyramid may carry a leading stream axis: ``[S, L, H, W]`` with
``[S, N]`` origins gives ``[S, N]`` angles and ``[S, N, 256]`` bits, all
from one launch (the multistream step describes its S frames so, as the
reference's ``vmap`` batches its ``pallas_call``); ``[L, H, W]`` is the
case S = 1.

``launches`` counts the kernel launches made through
``describe_keypoints``; a call made while a CUDA graph is captured
launches nothing and is not counted (a replay runs no Python).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from kbslam_torch.frontend import brief
from kbslam_torch.ops import patches as patch_ops

PATCH_SIZE = 40

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


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


@functools.lru_cache(maxsize=1)
def pair_table() -> np.ndarray:
    """[30, 256, 2] int16: per angle bin and bit, the flat patch offsets
    (i1, i2) of the two samples the bit compares, I2 - I1 > 0. Read off
    the rotated selection matrices (one -1 at i1, one +1 at i2 per row);
    a row whose two rotated points coincide is all zero there and gets
    i1 == i2, which gives the same 0 bit."""
    W = brief._rotated_selection_matrices()            # [30, 256, S^2] int8
    nonzero = (W != 0).sum(-1)
    if not (np.isin(nonzero, (0, 2)).all() and (W.sum(-1) == 0).all()):
        raise AssertionError("a selection row is not onehot(i2) - onehot(i1)")
    table = np.stack([np.argmin(W, -1), np.argmax(W, -1)], -1)
    table[nonzero == 0] = 0
    return table.astype(np.int16)


@functools.lru_cache(maxsize=8)
def _pair_table_on(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(pair_table()).to(device)


def _check(stacked, level, y0, x0):
    """Validates a [L, H, W] call or a [S, L, H, W] one (each stream's
    origins a row of [S, N])."""
    if stacked.ndim == 4:
        S = stacked.shape[0]
        for name, t in (("level", level), ("y0", y0), ("x0", x0)):
            if t.ndim != 2 or t.shape[0] != S:
                raise ValueError(f"{name} must be [{S}, N] for a pyramid of "
                                 f"{S} streams, got {tuple(t.shape)}")
        if not stacked.is_contiguous():
            raise ValueError("stacked must be contiguous")
        patch_ops._check(stacked[0], level[0], y0[0], x0[0], PATCH_SIZE)
        if (level.shape != y0.shape or level.shape != x0.shape
                or not (level.is_contiguous() and y0.is_contiguous()
                        and x0.is_contiguous())):
            raise ValueError("level, y0 and x0 must be contiguous and of "
                             "one shape")
        if stacked.numel() >= 2 ** 31 or level.numel() * 256 >= 2 ** 31:
            raise ValueError("describe_keypoints: too large for the kernel")
    else:
        patch_ops._check(stacked, level, y0, x0, PATCH_SIZE)
    # the kernel's bulk row copies start and end on 16-byte boundaries;
    # with W a multiple of 4 floats, every level and every stream's slab
    # starts on one too
    if stacked.shape[-1] % 4 or stacked.data_ptr() % 16:
        raise ValueError(f"describe_keypoints: the pyramid needs a width "
                         f"that is a multiple of 4 (got {stacked.shape[-1]}) "
                         f"and a 16-byte aligned start")


def describe_keypoints(stacked: torch.Tensor, level: torch.Tensor,
                       y0: torch.Tensor, x0: torch.Tensor, radius: int = 15):
    """[L, H, W] float32 pyramid, int32 [N] level/y0/x0 -> (angle [N]
    float32, bits [N, 256] uint8 in {0, 1}); or [S, L, H, W] and [S, N]
    -> [S, N] and [S, N, 256], in one launch."""
    global launches
    if stacked.device.type == "cpu":
        return describe_keypoints_reference(stacked, level, y0, x0, radius)
    if stacked.device.type != "cuda":
        raise ValueError(f"describe_keypoints: unsupported device "
                         f"{stacked.device}")
    if stacked.ndim not in (3, 4):
        raise ValueError(f"describe_keypoints: stacked must be [L, H, W] or "
                         f"[S, L, H, W], got {tuple(stacked.shape)}")
    _check(stacked, level, y0, x0)
    from kbslam_torch.ops._build import build

    lib = build().lib
    streams = stacked.shape[0] if stacked.ndim == 4 else 1
    L, H, W = stacked.shape[-3:]
    n = level.shape[-1]
    dev = stacked.device
    angle = torch.empty(level.shape, dtype=torch.float32, device=dev)
    bits = torch.empty(level.shape + (256,), dtype=torch.uint8, device=dev)
    if n == 0 or streams == 0:
        return angle, bits
    table = _pair_table_on(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.kbslam_describe_keypoints(
            stacked.data_ptr(), level.data_ptr(), y0.data_ptr(),
            x0.data_ptr(), table.data_ptr(), angle.data_ptr(),
            bits.data_ptr(), streams, n, L, H, W, int(radius), stream)
    if err != 0:
        msg = lib.kbslam_cuda_error_string(err).decode()
        raise RuntimeError(f"describe_keypoints kernel launch failed: {msg}")
    if not torch.cuda.is_current_stream_capturing():
        launches += 1
    return angle, bits
