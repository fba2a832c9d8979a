"""Batched patch extraction: the CUDA kernel and its plain twin.

Counterpart of the TPU kernel ``extract_patches_pallas``
(kbslam/ops/pallas_patches.py:112-160). For every keypoint ``n`` it
returns the S x S window ``stacked[level[n], y0[n]:y0[n]+S,
x0[n]:x0[n]+S]`` of the stacked pyramid, with the start clamp of
``jax.lax.dynamic_slice`` (level into [0, L-1], y0 into [0, H-S], x0
into [0, W-S]). It is an exact copy; the pyramid needs no padding.

- A CUDA tensor goes to the hand-written kernel
  (kbslam_torch/csrc/patches.cu) or the call raises.
- A CPU tensor goes to ``extract_patches_reference``, a batched gather
  that the tests hold against the JAX package.

``launches`` counts the kernel launches made through ``extract_patches``
(not the calls made while a CUDA graph is captured, which launch
nothing).
"""
from __future__ import annotations

import torch

PATCH_SIZE = 40

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


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


def _check(stacked, level, y0, x0, S):
    if stacked.dtype != torch.float32 or stacked.ndim != 3:
        raise ValueError(f"stacked must be float32 [L, H, W], got "
                         f"{stacked.dtype} {tuple(stacked.shape)}")
    L, H, W = stacked.shape
    if H < S or W < S or L < 1:
        raise ValueError(f"pyramid {tuple(stacked.shape)} smaller than the "
                         f"{S}x{S} patch")
    n = level.shape[0]
    for name, t in (("level", level), ("y0", y0), ("x0", x0)):
        if t.dtype != torch.int32 or t.ndim != 1 or t.shape[0] != n:
            raise ValueError(f"{name} must be int32 [{n}], got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != stacked.device:
            raise ValueError(f"{name} is on {t.device}, stacked on "
                             f"{stacked.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not stacked.is_contiguous():
        raise ValueError("stacked must be contiguous")
    if stacked.numel() >= 2 ** 31 or n * S * S >= 2 ** 31:
        raise ValueError("extract_patches: tensor too large for int32 counts")


def extract_patches(stacked: torch.Tensor, level: torch.Tensor,
                    y0: torch.Tensor, x0: torch.Tensor,
                    patch_size: int = PATCH_SIZE) -> torch.Tensor:
    """[L, H, W] float32 pyramid, int32 [N] level/y0/x0 -> [N, S, S]."""
    global launches
    if stacked.device.type == "cpu":
        return extract_patches_reference(stacked, level, y0, x0, patch_size)
    if stacked.device.type != "cuda":
        raise ValueError(f"extract_patches: unsupported device "
                         f"{stacked.device}")
    S = patch_size
    _check(stacked, level, y0, x0, S)
    from kbslam_torch.ops._build import build

    lib = build().lib
    L, H, W = stacked.shape
    n = level.shape[0]
    out = torch.empty((n, S, S), dtype=torch.float32, device=stacked.device)
    if n == 0:
        return out
    with torch.cuda.device(stacked.device):
        stream = torch.cuda.current_stream(stacked.device).cuda_stream
        err = lib.kbslam_extract_patches(
            stacked.data_ptr(), level.data_ptr(), y0.data_ptr(),
            x0.data_ptr(), out.data_ptr(), n, L, H, W, S, stream)
    if err != 0:
        msg = lib.kbslam_cuda_error_string(err).decode()
        raise RuntimeError(f"extract_patches kernel launch failed: {msg}")
    if not torch.cuda.is_current_stream_capturing():
        launches += 1
    return out
