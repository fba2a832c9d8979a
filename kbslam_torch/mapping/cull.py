"""Keyframe culling, disabled by default as in the reference
(Map.cpp:107-177, its call site Map.cpp:63 commented out;
CullConfig.enabled mirrors that).

Port of kbslam/mapping/cull.py. The first and last keyframes survive; a
middle one survives when its motion to either neighbour exceeds 1.5 m or
0.1 rad (Map.cpp:128-132); if fewer than 5 would survive, keyframes are
kept again from the second-newest backwards (Map.cpp:135-145). Culled
keyframes are invalidated in place in the ring (kf_id -1, keypoints
invalid, landmark references cleared), and landmarks left with fewer
than 2 observations lose their other references (Map.cpp:153-167).
"""
from __future__ import annotations

import torch

from kbslam_torch.geom.se3 import SE3
from kbslam_torch.mapping.state import MapState


def cull_decision(kf_q, kf_t, valid, cfg) -> torch.Tensor:
    """Keep mask per position, on poses ordered oldest to newest.

    kf_q/kf_t: [N, 4]/[N, 3] poses of the valid keyframes in order;
    valid: [N] bool (invalid rows are padding and never kept)."""
    n = kf_q.shape[0]
    count = torch.sum(valid.to(torch.int32))
    T = SE3(kf_q, kf_t)
    prev = SE3(torch.roll(kf_q, 1, 0), torch.roll(kf_t, 1, 0))
    nxt = SE3(torch.roll(kf_q, -1, 0), torch.roll(kf_t, -1, 0))
    rel_p = prev.inverse().compose(T)
    rel_n = T.inverse().compose(nxt)
    keep = ((rel_p.translation_norm() > cfg.translation_threshold)
            | (rel_n.translation_norm() > cfg.translation_threshold)
            | (rel_p.rotation_angle() > cfg.rotation_threshold)
            | (rel_n.rotation_angle() > cfg.rotation_threshold))
    idx = torch.arange(n, device=kf_q.device)
    # first maxima, as jnp.argmax
    first_idx = torch.argmax(valid.to(torch.int32))
    last_idx = n - 1 - torch.argmax(torch.flip(valid, (0,)).to(torch.int32))
    keep = (keep | (idx == first_idx) | (idx == last_idx)) & valid

    # at least min_keep survive: keep again from the second-newest back
    deficit = torch.clamp(cfg.min_keep - torch.sum(keep.to(torch.int32)),
                          min=0)
    cand = valid & ~keep & (idx != last_idx)
    rank = torch.where(cand, idx, -1)
    order = torch.argsort(-rank, stable=True)
    take = torch.zeros_like(valid).scatter(0, order, idx < deficit)
    keep = keep | (take & cand)
    return torch.where(count <= cfg.min_keep, valid, keep)


def cull_keyframes(state: MapState, cfg) -> MapState:
    """Apply the cull decision to the ring: ``kf_id``, ``kf_kp_valid`` and
    ``kf_mp`` are written in place; returns the state."""
    P = state.capacity_mp
    # positions ordered by insertion id; empty slots (id < 0) are padding
    order = torch.argsort(torch.where(state.kf_id >= 0, state.kf_id, 1 << 30),
                          stable=True)
    kf_id_o = state.kf_id.index_select(0, order)
    keep_ord = cull_decision(state.kf_q.index_select(0, order),
                             state.kf_t.index_select(0, order),
                             kf_id_o >= 0, cfg)
    keep = torch.zeros_like(keep_ord).scatter(0, order, keep_ord)
    dropped = (state.kf_id >= 0) & ~keep

    # landmarks lose the observations of dropped keyframes (stale
    # references count as already gone)
    kf_mp = torch.where(dropped[:, None], -1, state.kf_mp)
    live = state.mp_ref_live(kf_mp)
    slot = state.mp_ref_slot(kf_mp).to(torch.int64)
    safe = torch.where(live, slot, P).reshape(-1)
    obs = torch.zeros(P + 1, dtype=torch.int32, device=kf_mp.device)
    obs.index_add_(0, safe, torch.ones_like(safe, dtype=torch.int32))
    # MapPoint::IsBad cleanup: fewer than 2 observations clears the rest
    bad = (obs[:P] < 2).index_select(0, slot.reshape(-1)).reshape(slot.shape)
    kf_mp = torch.where((bad | ~live) & (kf_mp >= 0), -1, kf_mp)

    state.kf_id.copy_(torch.where(dropped, -1, state.kf_id))
    state.kf_kp_valid.copy_(state.kf_kp_valid & ~dropped[:, None])
    state.kf_mp.copy_(kf_mp)
    return state


def make_cull(cfg):
    """``map -> map`` with the CullConfig bound."""
    return lambda m: cull_keyframes(m, cfg)
