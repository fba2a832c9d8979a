"""Loop closure end to end: build the pose graph from a map, solve it, and
write corrected keyframe poses and landmarks back.

Port of kbslam/loop/closure.py. Nodes are indexed by age rank: node r is
the keyframe with id id_min + r, in ring slot (id_min + r) % capacity.
Rank 0, the oldest live keyframe, is the gauge. Odometry edges join
consecutive ranks with relative poses from the current map; the verified
loop constraint is the last edge. Each landmark rides its oldest live
observer's correction, X' = T_new(ref) T_old(ref)^-1 X.

The write-back is functional: the new map has new ``kf_q``, ``kf_t`` and
``mp_pos`` tensors and the input map is left as it was. On CUDA the
close is launch-bound (~63k small kernels for a 64-keyframe ring); the
loop runner replays it as one captured CUDA graph. The reference's
loop of ``.at[].min`` over the keyframes is one ``scatter_reduce`` of
every (rank, landmark) pair with ``amin``, into a buffer with a spare
row for the pairs that take no part (integer, so exact).
"""
from __future__ import annotations

from typing import Tuple

import torch

from kbslam_torch.geom.se3 import SE3
from kbslam_torch.loop.pose_graph import PoseGraph, solve_pose_graph
from kbslam_torch.mapping.state import scatter_rows, take_row


def _identity_q(n: int, like: torch.Tensor) -> torch.Tensor:
    return SE3.identity((n,), dtype=like.dtype, device=like.device).q


def build_pose_graph(m, loop_slot_i, loop_slot_j, loop_rel_q, loop_rel_t,
                     loop_w: float = 1.0,
                     loop_ok=None) -> Tuple[PoseGraph, torch.Tensor]:
    """PoseGraph over the live keyframes of a map plus one loop edge
    between ring slots (i, j) (0-d tensors) with measured T_ij. Returns
    (graph, id_min); id_min maps node ranks back to ring slots. With
    loop_ok False the loop edge has zero weight."""
    K = m.capacity_kf
    dev = m.kf_q.device
    n_live = torch.clamp(m.num_kf, max=K)
    id_min = m.num_kf - n_live                     # oldest live id

    ranks = torch.arange(K, dtype=torch.int32, device=dev)
    slots = torch.remainder(id_min + ranks, K).to(torch.int64)
    node_valid = ranks < n_live
    node_q = torch.where(node_valid[:, None], m.kf_q.index_select(0, slots),
                         _identity_q(K, m.kf_q))
    node_t = torch.where(node_valid[:, None], m.kf_t.index_select(0, slots),
                         0.0)

    # odometry edges (r, r+1) from the current map poses
    e_i = ranks
    e_j = torch.clamp(ranks + 1, max=K - 1)
    odo_valid = (ranks + 1) < n_live
    Ti = SE3(node_q, node_t)
    Tj = SE3(node_q.index_select(0, e_j.to(torch.int64)),
             node_t.index_select(0, e_j.to(torch.int64)))
    rel = Ti.inverse().compose(Tj).normalize()

    # the loop edge in the last slot: ring slots -> ranks
    li = take_row(m.kf_id, loop_slot_i) - id_min
    lj = take_row(m.kf_id, loop_slot_j) - id_min
    ok = (li >= 0) & (lj >= 0)
    if loop_ok is not None:
        ok = ok & loop_ok
    edge_i = torch.cat([e_i, li.reshape(1).to(torch.int32)])
    edge_j = torch.cat([e_j, lj.reshape(1).to(torch.int32)])
    edge_w = torch.cat([odo_valid.to(torch.float32),
                        torch.where(ok, loop_w, 0.0).reshape(1)
                        .to(torch.float32)])
    g = PoseGraph(node_q=node_q, node_t=node_t, node_valid=node_valid,
                  edge_i=torch.where(edge_w > 0, edge_i, 0),
                  edge_j=torch.where(edge_w > 0, edge_j, 0),
                  rel_q=torch.cat([rel.q, loop_rel_q.reshape(1, 4)]),
                  rel_t=torch.cat([rel.t, loop_rel_t.reshape(1, 3)]),
                  edge_w=edge_w)
    return g, id_min


def _landmark_ref_rank(m, id_min) -> torch.Tensor:
    """[P] age rank of each landmark slot's oldest live observer
    (capacity_kf where unobserved)."""
    K, P = m.capacity_kf, m.capacity_mp
    dev = m.kf_q.device
    ranks = torch.arange(K, dtype=torch.int64, device=dev)
    rows = m.kf_mp.index_select(0, torch.remainder(id_min + ranks, K))  # [K, F]
    live = (m.mp_ref_live(rows)
            & (ranks < torch.clamp(m.num_kf, max=K))[:, None])
    pslots = torch.where(live, m.mp_ref_slot(rows).to(torch.int64), P)
    ref = torch.full((P + 1,), K, dtype=torch.int64, device=dev)
    ref.scatter_reduce_(0, pslots.reshape(-1),
                        ranks[:, None].expand_as(pslots).reshape(-1), "amin")
    return ref[:P]


def apply_pose_graph_correction(m, g: PoseGraph, id_min):
    """Write the solved node poses back to the ring and carry each
    landmark rigidly with its reference keyframe's correction."""
    K = m.capacity_kf
    ranks = torch.arange(K, dtype=torch.int32, device=m.kf_q.device)
    slots = torch.remainder(id_min + ranks, K)

    # per-rank correction D_r = T_new T_old^-1 (identity on dead ranks)
    s64 = slots.to(torch.int64)
    T_old = SE3(m.kf_q.index_select(0, s64), m.kf_t.index_select(0, s64))
    D = SE3(g.node_q, g.node_t).compose(T_old.inverse()).normalize()
    Dq = torch.where(g.node_valid[:, None], D.q, _identity_q(K, D.q))
    Dt = torch.where(g.node_valid[:, None], D.t, 0.0)

    kf_q = scatter_rows(m.kf_q, slots, g.node_valid, g.node_q)
    kf_t = scatter_rows(m.kf_t, slots, g.node_valid, g.node_t)

    rank = _landmark_ref_rank(m, id_min)
    ref = torch.clamp(rank, 0, K - 1)
    observed = rank < K
    Dl = SE3(Dq.index_select(0, ref), Dt.index_select(0, ref))
    mp_pos = torch.where(observed[:, None], Dl.apply(m.mp_pos), m.mp_pos)
    return m._replace(kf_q=kf_q, kf_t=kf_t, mp_pos=mp_pos)


def close_loop(m, loop_slot_i, loop_slot_j, loop_rel_q, loop_rel_t,
               loop_ok=None, loop_w: float = 1.0, max_iterations: int = 50):
    """Build, solve and write back. With loop_ok False the loop edge has
    zero weight, the odometry-only graph is at its optimum and the map
    comes back unchanged up to float rounding, so callers may dispatch
    without a branch. Returns (new map, PoseGraphStats)."""
    g, id_min = build_pose_graph(m, loop_slot_i, loop_slot_j, loop_rel_q,
                                 loop_rel_t, loop_w=loop_w, loop_ok=loop_ok)
    g2, stats = solve_pose_graph(g, max_iterations=max_iterations)
    return apply_pose_graph_correction(m, g2, id_min), stats


def make_close_loop(max_iterations: int = 50, loop_w: float = 1.0):
    """``(map, slot_i, slot_j, rel_q, rel_t, ok) -> (map, stats)`` with
    LoopConfig's ``max_iterations`` and ``loop_weight`` bound."""
    return lambda m, si, sj, rq, rt, ok: close_loop(
        m, si, sj, rq, rt, loop_ok=ok, loop_w=loop_w,
        max_iterations=max_iterations)


