"""Compact observation and landmark layout of a window problem.

Port of kbslam/ba/compact.py. The padded [W, F] observation layout holds
~15k slots of which a few thousand are active, and the landmark ring has
P = 65,536 rows; the problem is compacted once per solve into

  - O observation slots, the active observations first (stable), then
    padding;
  - L landmark slots, one per distinct window landmark,

so every LM trip works on [O]- and [L]-sized tensors. The layout is made
of sorts, prefix sums and scatters into a spare row: no ``unique``, mask
indexing or ``nonzero``, each of which reads a size from the device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from slambench.reference.ba.problem import BAProblem


class CompactProblem(NamedTuple):
    # observations, active first, capacity O
    obs_valid: torch.Tensor    # [O] bool
    obs_w: torch.Tensor        # [O] int32 window-camera index
    obs_uv: torch.Tensor       # [O, 2]
    obs_wz: torch.Tensor       # [O] depth loss scale
    obs_zmeas: torch.Tensor    # [O] measured keypoint depth (m)
    obs_wd: torch.Tensor       # [O] depth-residual weight 1/sigma^2 (0 = off)
    obs_l: torch.Tensor        # [O] int32 compact landmark id (L = padding)
    # landmarks, capacity L
    uniq_global: torch.Tensor  # [L] int32 landmark slot (-1 = padding)
    Xc: torch.Tensor           # [L, 3] positions (a compact copy)
    l_valid: torch.Tensor      # [L] bool
    anchor_l: torch.Tensor     # [] int32 compact id of the depth anchor (-1)


def _scatter_spare(size: int, fill: int, idx: torch.Tensor,
                   values: torch.Tensor) -> torch.Tensor:
    """A [size] int32 vector of ``fill`` with out[idx] = values, where
    idx == size marks a lane to drop (it lands in a spare row). The kept
    lanes have distinct targets, so the result is the same in any order."""
    out = torch.full((size + 1,), fill, dtype=torch.int32, device=idx.device)
    out.index_put_((idx.to(torch.int64),), values.to(torch.int32))
    return out[:size]


def compact_problem(prob: BAProblem, mp_pos: torch.Tensor, O: int,
                    L: int) -> CompactProblem:
    W, F = prob.mp_id.shape
    P = mp_pos.shape[0]
    dev = mp_pos.device

    active = prob.active.reshape(-1)
    mp_flat = torch.where(active, prob.mp_id.reshape(-1), P)
    w_flat = torch.arange(W, dtype=torch.int32,
                          device=dev)[:, None].expand(W, F).reshape(-1)

    # active observations first (stable), cut to O
    order = torch.sort((~active).to(torch.uint8), stable=True).indices[:O]
    obs_valid = active[order]
    obs_w = w_flat[order]
    obs_uv = prob.obs_uv.reshape(W * F, 2)[order]
    obs_wz = torch.where(obs_valid, prob.w_z.reshape(-1)[order], 0.0)
    obs_zmeas = torch.where(obs_valid, prob.z_meas.reshape(-1)[order], 0.0)
    obs_wd = torch.where(obs_valid, prob.w_d.reshape(-1)[order], 0.0)
    gids = torch.where(obs_valid, mp_flat[order], P)       # [O] slots

    # landmark compaction: sort the ids, mark the first of each, rank by
    # prefix sum
    sorted_g = torch.sort(gids).values
    first = torch.ones(1, dtype=torch.bool, device=dev)
    is_new = (sorted_g < P) & torch.cat([first, sorted_g[1:] != sorted_g[:-1]])
    rank = torch.cumsum(is_new.to(torch.int32), dim=0) - 1
    kept = is_new & (rank < L)
    # slot -> compact id (L where absent), row P included
    table = _scatter_spare(P + 1, L, torch.where(is_new, sorted_g, P + 1),
                           torch.where(kept, rank, L))
    obs_l = table.index_select(0, gids.to(torch.int64))   # [O]
    obs_valid = obs_valid & (obs_l < L)

    uniq_global = _scatter_spare(L, -1, torch.where(kept, rank, L), sorted_g)
    l_valid = uniq_global >= 0
    Xc = torch.where(l_valid[:, None], mp_pos.index_select(
        0, torch.clamp(uniq_global, min=0).to(torch.int64)), 0.0)

    anchor_l = torch.where(
        prob.anchor_mp >= 0,
        table.index_select(0, torch.clamp(prob.anchor_mp, 0, P).reshape(1)
                           .to(torch.int64))[0],
        L)
    anchor_l = torch.where(anchor_l >= L, -1, anchor_l).to(torch.int32)

    return CompactProblem(
        obs_valid=obs_valid, obs_w=obs_w, obs_uv=obs_uv, obs_wz=obs_wz,
        obs_zmeas=obs_zmeas, obs_wd=obs_wd,
        obs_l=torch.where(obs_valid, obs_l, L),
        uniq_global=uniq_global, Xc=Xc, l_valid=l_valid, anchor_l=anchor_l)
