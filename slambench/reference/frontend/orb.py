"""ORB feature extraction: grayscale -> keypoints + descriptors.

Port of kbslam/frontend/orb.py: per-level dense FAST + NMS + Harris
maps, top-k selection into a fixed per-level quota, parabolic subpixel
offsets, IC orientation and rBRIEF from 40x40 patches — padded to
``max_features`` with a validity mask. The patches, angles and bits come
from one fused kernel (``ops/describe.py``), which never writes the
patches out.

Every function also takes images with leading axes, [S, H, W] for the
multistream step: the pyramid and the stencils act on all S at once,
each stream sorts and gathers only its own candidates, and one describe
launch covers all S x ``max_features`` keypoints.
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from slambench.reference.frontend import brief
from slambench.reference.frontend.fast import border_mask, fast_score_map, nms3x3
from slambench.reference.frontend.harris import harris_response
from slambench.reference.frontend.image import (
    build_pyramid, gaussian_blur, pyramid_sizes, rgb_to_gray, shift2d)
from slambench.reference.ops.describe import describe_keypoints
from slambench.reference.ops.incidence import incidence_gather

_NEG = -1e30


def _parabolic_offset(sm, s0, sp):
    """Vertex of the parabola through (-1, sm), (0, s0), (1, sp) in [-.5, .5]."""
    denom = sm - 2.0 * s0 + sp
    off = 0.5 * (sm - sp) / torch.where(torch.abs(denom) < 1e-12, 1e-12, denom)
    return torch.clamp(off, -0.5, 0.5)


class Features(NamedTuple):
    """Padded keypoint set for one image (capacity = orb.max_features),
    or for S images with a leading axis on every field."""

    xy: torch.Tensor        # [F, 2] float32, level-0 pixel coords (x, y)
    response: torch.Tensor  # [F] float32 Harris response
    angle: torch.Tensor     # [F] float32 radians
    level: torch.Tensor     # [F] int32 pyramid level
    valid: torch.Tensor     # [F] bool
    desc: torch.Tensor      # [F, 256] uint8 bits in {0, 1}

    @property
    def capacity(self) -> int:
        return self.xy.shape[-2]

    def count(self) -> torch.Tensor:
        return torch.sum(self.valid.to(torch.int32), dim=-1)


def level_quotas(cfg) -> List[int]:
    """The detection budget per level, like cv::ORB: geometric decay with
    ratio 1/scale, remainder to the last level; sums to
    min(num_features, max_features)."""
    factor = 1.0 / cfg.scale_factor
    n = min(cfg.num_features, cfg.max_features)
    ndesired = n * (1 - factor) / (1 - factor ** cfg.num_levels)
    quotas = []
    for lv in range(cfg.num_levels - 1):
        quotas.append(int(round(ndesired * factor ** lv)))
    quotas.append(n - sum(quotas))
    return quotas


@functools.lru_cache(maxsize=64)
def _nearest_index(m: int, n: int, device: torch.device) -> torch.Tensor:
    """Source index of each of n outputs of an m -> n nearest resize,
    as ``jax.image.resize(method="nearest")`` computes it under jit:
    floor((i + 0.5) * m / n) in float32, where XLA folds ``* m / n`` into
    one multiply by fl(m * fl(1 / n)). ``F.interpolate`` differs."""
    f32 = np.float32
    ratio = f32(f32(m) * (f32(1) / f32(n)))
    idx = np.floor((np.arange(n, dtype=f32) + f32(0.5)) * ratio)
    return torch.from_numpy(idx.astype(np.int64)).to(device)


def resize_mask_nearest(mask: torch.Tensor, hl: int, wl: int) -> torch.Tensor:
    """[..., H, W] mask -> [..., hl, wl] bool (nonzero = keep)."""
    h, w = mask.shape[-2:]
    out = mask
    if hl != h:
        out = out[..., _nearest_index(h, hl, mask.device), :]
    if wl != w:
        out = out[..., _nearest_index(w, wl, mask.device)]
    return out != 0


@functools.lru_cache(maxsize=16)
def _level_tables(sizes: tuple, scale_factor: float, device: torch.device):
    """([L, 2] int32 level (h, w), [L] float32 level scale) on ``device``."""
    dims = torch.tensor(sizes, dtype=torch.int32, device=device)
    scales = torch.tensor([scale_factor ** lv for lv in range(len(sizes))],
                          dtype=torch.float32, device=device)
    return dims, scales


def topk_stable(values: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties to the
    lower index — the order ``lax.top_k`` gives; ``torch.topk`` breaks
    ties otherwise."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_level(cand: torch.Tensor, harris: torch.Tensor, k: int):
    """One level's k strongest candidates: (xy [..., k, 2] level coords
    with subpixel offsets, valid [..., k], response [..., k]) of
    [..., hl, wl] maps, each image's own.

    The exact top-k (the reference's approx_max_k is exact on CPU). The
    subpixel offsets are parabola fits on the Harris response around the
    integer maximum, as dense maps with both axes packed into one value
    (quantized to 1/1024 px) — the reference's encoding, kept so the
    coordinates match it exactly."""
    wl = cand.shape[-1]
    dxm = _parabolic_offset(shift2d(harris, 0, -1), harris,
                            shift2d(harris, 0, 1))
    dym = _parabolic_offset(shift2d(harris, -1, 0), harris,
                            shift2d(harris, 1, 0))
    enc = (torch.round((dxm + 0.5) * 1024.0) * 2048.0
           + torch.round((dym + 0.5) * 1024.0))
    flat = cand.shape[:-2] + (-1,)
    vals, idx = topk_stable(cand.reshape(flat), k)
    valid = vals > _NEG * 0.5
    xi = idx % wl
    yi = idx // wl
    e = torch.gather(enc.reshape(flat), -1, idx)
    dx_off = torch.floor(e / 2048.0) * (1.0 / 1024.0) - 0.5
    dy_off = torch.remainder(e, 2048.0) * (1.0 / 1024.0) - 0.5
    xy = torch.stack([xi.to(torch.float32) + dx_off,
                      yi.to(torch.float32) + dy_off], dim=-1)
    return xy, valid, vals


def detect_and_compute(gray: torch.Tensor, mask: Optional[torch.Tensor],
                       cfg) -> Features:
    """[..., H, W] float32 grayscale (+ optional nonzero=keep mask of
    the same shape) -> Features with the same leading axes."""
    dev = gray.device
    batch = tuple(gray.shape[:-2])
    h, w = gray.shape[-2:]
    sizes = pyramid_sizes(h, w, cfg.num_levels, cfg.scale_factor)
    quotas = level_quotas(cfg)
    pyr = build_pyramid(gray, cfg.num_levels, cfg.scale_factor)

    h0, w0 = sizes[0]
    xy_parts, val_parts, lvl_parts, resp_parts = [], [], [], []
    # the describe kernel copies rows in 16-byte pieces: the width is
    # padded to a multiple of 4 floats (zeros no patch reaches)
    stacked_blur = torch.zeros(batch + (cfg.num_levels, h0, -(-w0 // 4) * 4),
                               dtype=torch.float32, device=dev)
    for lv in range(cfg.num_levels):
        img = pyr[lv]
        hl, wl = sizes[lv]
        score = nms3x3(fast_score_map(img, float(cfg.fast_threshold)))
        region = border_mask(hl, wl, cfg.edge_threshold, dev)
        if mask is not None:
            region = region & resize_mask_nearest(mask, hl, wl)
        harris = harris_response(img, cfg.harris_block_size, cfg.harris_k)
        cand = torch.where((score > 0) & region, harris, _NEG)
        k = quotas[lv]
        xy_l, valid, vals = select_level(cand, harris, k)

        stacked_blur[..., lv, :hl, :wl] = gaussian_blur(img, cfg.blur_kernel,
                                                        cfg.blur_sigma)
        xy_parts.append(xy_l)
        val_parts.append(valid)
        resp_parts.append(vals)
        lvl_parts.append(torch.full(batch + (k,), lv, dtype=torch.int32,
                                    device=dev))

    xy_lvl = torch.cat(xy_parts, dim=-2)             # level coords
    levels = torch.cat(lvl_parts, dim=-1)
    valid = torch.cat(val_parts, dim=-1)
    resp = torch.cat(resp_parts, dim=-1)

    # pad the detection budget up to the static capacity
    pad = cfg.max_features - xy_lvl.shape[-2]
    if pad > 0:
        xy_lvl = torch.cat([xy_lvl, xy_lvl.new_zeros(batch + (pad, 2))], -2)
        levels = torch.cat([levels, levels.new_zeros(batch + (pad,))], -1)
        valid = torch.cat([valid, valid.new_zeros(batch + (pad,))], -1)
        resp = torch.cat([resp, resp.new_full(batch + (pad,), _NEG)], -1)

    # block-locality order: (level, 48-row block, 128-col block), stable.
    # It was chosen for the TPU kernel's block reuse; it is kept because
    # it fixes the feature order every later stage sees.
    xi = torch.clamp(torch.round(xy_lvl[..., 0]).to(torch.int32), 0, w0 - 1)
    yi = torch.clamp(torch.round(xy_lvl[..., 1]).to(torch.int32), 0, h0 - 1)
    sort_key = (levels * 32 + yi // 48) * 32 + xi // 128
    order = torch.argsort(sort_key, dim=-1, stable=True)
    tab = torch.cat([xy_lvl, resp[..., None],
                     valid[..., None].to(torch.float32),
                     levels[..., None].to(torch.float32)], dim=-1)
    tab_p = incidence_gather(order, tab)             # [..., F, 5], exact
    xy_lvl = tab_p[..., :2]
    resp = tab_p[..., 2]
    valid = tab_p[..., 3] > 0.5
    levels = tab_p[..., 4].to(torch.int32)

    # one pass for all levels (and streams): each keypoint's 40x40
    # patch, its IC orientation and its rBRIEF bits
    level_dims, level_scale = _level_tables(tuple(sizes), cfg.scale_factor,
                                            dev)
    y0, x0 = brief.patch_origins(level_dims, xy_lvl, levels)
    angle, desc = describe_keypoints(stacked_blur, levels.contiguous(), y0,
                                     x0, radius=cfg.patch_size // 2)

    scales = level_scale[levels.to(torch.int64)]
    return Features(xy=xy_lvl * scales[..., None], response=resp,
                    angle=angle, level=levels, valid=valid, desc=desc)


def extract(img: torch.Tensor, mask: Optional[torch.Tensor], cfg,
            batched: bool = False) -> Features:
    """RGB uint8 [H, W, 3] (or grayscale [H, W]) -> Features; with
    ``batched``, [S, H, W, 3] (or [S, H, W]) and Features over S."""
    rgb = img.ndim == 3 + int(batched)
    gray = rgb_to_gray(img) if rgb else img.to(torch.float32)
    return detect_and_compute(gray, mask, cfg)
