"""Sliding-window local bundle adjustment: build, solve, write back.

Port of kbslam/ba/local_ba.py. ``local_ba`` is a function from a map to
a new map: its writeback builds new ``kf_q``, ``kf_t``, ``mp_pos`` and
``kf_mp`` tensors and leaves the input's untouched, so a snapshot handed
to an asynchronous solve never shares storage with the live map that
the tracking step keeps writing in place.

After the solve a window landmark is pruned when it has fewer than 2
window observations, fewer than 2 gated-in observations, or a gated-in
share below 0.4; pruning clears the window keyframes' references only.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from slambench.reference.ba.compact import compact_problem
from slambench.reference.ba.compact_lm import solve_window_compact
from slambench.reference.ba.merge import merge_ba_result
from slambench.reference.ba.problem import build_problem
from slambench.reference.geom.camera import Intrinsics
from slambench.reference.mapping.state import MapState, device_copy, scatter_rows


class BAStats(NamedTuple):
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    iterations: torch.Tensor
    accepted: torch.Tensor     # LM steps that decreased the cost
    num_pruned: torch.Tensor


def stats_vector(stats: BAStats) -> torch.Tensor:
    """The five stats as one float64 vector (one copy to the host)."""
    return torch.stack([x.to(torch.float64) for x in stats])


def stats_record(v, wall_ms=None) -> dict:
    """The host record of one solve from its ``stats_vector``."""
    return dict(initial_cost=float(v[0]), final_cost=float(v[1]),
                iterations=int(v[2]), accepted=int(v[3]),
                num_pruned=int(v[4]), wall_ms=wall_ms)


def local_ba(state: MapState, intr: Intrinsics,
             cfg) -> Tuple[MapState, BAStats]:
    prob = build_problem(state, intr, cfg)
    cp = compact_problem(prob, state.mp_pos, cfg.compact_obs,
                         cfg.compact_landmarks)
    sol = solve_window_compact(prob, cp, intr, cfg)

    ran = state.num_kf >= 2    # nothing to optimize below two keyframes

    # --- pose and point writeback; padded window slots write nothing ------
    rows = prob.real & ran
    kf_q = scatter_rows(state.kf_q, prob.slots, rows, sol.cam_q)
    kf_t = scatter_rows(state.kf_t, prob.slots, rows, sol.cam_t)
    mp_pos = scatter_rows(state.mp_pos, cp.uniq_global, cp.l_valid & ran,
                          sol.Xc)

    # --- pruning ------------------------------------------------------------
    total = prob.total_obs
    inl = prob.inlier_obs
    ratio = inl.to(torch.float32) / torch.clamp(total.to(torch.float32),
                                                min=1.0)
    drop = prob.touched & (
        (total < cfg.prune_min_obs)
        | (inl < cfg.prune_min_inlier_kfs)
        | (ratio < cfg.prune_min_inlier_ratio)
    ) & ran

    window_rows = state.kf_mp.index_select(0, prob.slots.to(torch.int64))
    live = state.mp_ref_live(window_rows)
    slot = state.mp_ref_slot(window_rows).reshape(-1).to(torch.int64)
    dropped_here = drop.index_select(0, slot).reshape(live.shape) & live
    new_rows = torch.where(dropped_here, -1, window_rows)
    kf_mp = scatter_rows(state.kf_mp, prob.slots, rows, new_rows)

    stats = BAStats(
        initial_cost=sol.initial_cost,
        final_cost=sol.final_cost,
        iterations=sol.iterations,
        accepted=sol.accepted,
        num_pruned=torch.sum(drop.to(torch.int32)),
    )
    return state._replace(kf_q=kf_q, kf_t=kf_t, mp_pos=mp_pos,
                          kf_mp=kf_mp), stats
