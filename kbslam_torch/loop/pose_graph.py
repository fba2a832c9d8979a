"""SE(3) pose-graph optimization, the loop-closure backend.

Port of kbslam/loop/pose_graph.py: a padded graph of N node slots and E
edge slots (masked), the relative-pose residual r_e = log(T_meas^-1
T_i^-1 T_j) with a left-multiplicative retraction, the Jacobian by
forward-mode differentiation at delta = 0 (``torch.func.jacfwd``, [6E,
6N]), and a damped Gauss-Newton loop with the local BA's accept/reject
schedule. Node 0 (the oldest live keyframe) is the gauge.

The reference's ``while_loop`` stops early; here the loop runs all
``max_iterations`` trips and masks every update after ``done``, its
``lax.cond`` re-linearisation computes both branches and selects, and the
dense solve is ``torch.linalg.solve_ex`` without its check, so a solve
makes no host sync (the same changes as ``ba/compact_lm.py``).
``iterations`` and ``accepted`` count as the reference counts them.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from kbslam_torch.geom.se3 import SE3


class PoseGraph(NamedTuple):
    """Padded pose graph. Invalid nodes/edges carry weight/valid 0."""

    node_q: torch.Tensor      # [N, 4] T_wc rotation (w, x, y, z)
    node_t: torch.Tensor      # [N, 3]
    node_valid: torch.Tensor  # [N] bool
    edge_i: torch.Tensor      # [E] int32 source node index
    edge_j: torch.Tensor      # [E] int32 target node index
    rel_q: torch.Tensor       # [E, 4] measured T_ij = T_i^-1 T_j
    rel_t: torch.Tensor       # [E, 3]
    edge_w: torch.Tensor      # [E] float32 weight (0 = padding edge)


class PoseGraphStats(NamedTuple):
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    iterations: torch.Tensor
    accepted: torch.Tensor


def _edge_residuals(node_q, node_t, g: PoseGraph) -> torch.Tensor:
    """[E, 6] whitened residuals log(T_meas^-1 T_i^-1 T_j)."""
    ei, ej = g.edge_i.to(torch.int64), g.edge_j.to(torch.int64)
    Ti = SE3(node_q.index_select(0, ei), node_t.index_select(0, ei))
    Tj = SE3(node_q.index_select(0, ej), node_t.index_select(0, ej))
    err = SE3(g.rel_q, g.rel_t).inverse().compose(Ti.inverse().compose(Tj))
    return err.log() * torch.sqrt(g.edge_w)[:, None]


def _retract(node_q, node_t, delta, free):
    """Left-multiplicative update T_i <- exp(delta_i) T_i on free nodes."""
    T = SE3.exp(delta).compose(SE3(node_q, node_t)).normalize()
    return (torch.where(free[:, None], T.q, node_q),
            torch.where(free[:, None], T.t, node_t))


def solve_pose_graph(g: PoseGraph, max_iterations: int = 50,
                     init_lambda: float = 1e-6, fn_tol: float = 1e-9
                     ) -> Tuple[PoseGraph, PoseGraphStats]:
    """Damped Gauss-Newton (LM accept/reject) on the padded graph; returns
    the graph with optimized node poses and the solve's stats."""
    N = g.node_q.shape[0]
    dev = g.node_q.device
    free = g.node_valid & (torch.arange(N, device=dev) != 0)  # node 0 = gauge
    freef = free.to(torch.float32).repeat_interleave(6)

    def cost_fn(q, t):
        r = _edge_residuals(q, t, g)
        return torch.sum(r * r)

    def linearize(q, t):
        def r_of_delta(delta):
            q2, t2 = _retract(q, t, delta.reshape(N, 6), free)
            return _edge_residuals(q2, t2, g).reshape(-1)

        J = torch.func.jacfwd(r_of_delta)(
            torch.zeros(6 * N, dtype=q.dtype, device=dev))     # [6E, 6N]
        r = _edge_residuals(q, t, g).reshape(-1)
        return J.T @ J, -(J.T @ r)

    def lm_step(q, t, lam, cost, H, b, it, acc, done):
        # damp + gauge/padding mask (unit diagonal on fixed dofs)
        Hd = H + lam * torch.diag(torch.clamp(torch.diagonal(H), 1e-8, 1e32))
        Hd = Hd * freef[:, None] * freef[None, :] + torch.diag(1.0 - freef)
        delta = torch.linalg.solve_ex(Hd, b * freef).result
        q2, t2 = _retract(q, t, (delta * freef).reshape(N, 6), free)
        new_cost = cost_fn(q2, t2)
        finite = torch.isfinite(new_cost) & torch.all(torch.isfinite(delta))
        accept = finite & (new_cost < cost) & ~done

        q = torch.where(accept, q2, q)
        t = torch.where(accept, t2, t)
        cost_out = torch.where(accept, new_cost, cost)
        # the reference's lax.cond: both branches, then select
        H2, b2 = linearize(q2, t2)
        H = torch.where(accept, H2, H)
        b = torch.where(accept, b2, b)
        lam = torch.where(done, lam, torch.clamp(
            torch.where(accept, lam / 3.0, lam * 4.0), 1e-10, 1e10))
        rel = torch.abs(cost - cost_out) / torch.clamp(cost, min=1e-18)
        done = done | (accept & (rel < fn_tol)) | (lam >= 1e10)
        it = torch.where(done, it, it + 1)
        acc = acc + accept.to(torch.int32)
        return q, t, lam, cost_out, H, b, it, acc, done

    H0, b0 = linearize(g.node_q, g.node_t)
    cost0 = cost_fn(g.node_q, g.node_t)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    carry = (g.node_q, g.node_t,
             torch.full((), init_lambda, dtype=torch.float32, device=dev),
             cost0, H0, b0, zero, zero,
             torch.zeros((), dtype=torch.bool, device=dev))
    for _ in range(max_iterations):
        carry = lm_step(*carry)
    q, t, _, cost, _, _, it, acc, _ = carry
    stats = PoseGraphStats(initial_cost=cost0, final_cost=cost,
                           iterations=it, accepted=acc)
    return g._replace(node_q=q, node_t=t), stats


def make_pose_graph_solver(max_iterations: int = 50,
                           init_lambda: float = 1e-6):
    """``graph -> (graph, PoseGraphStats)`` with the settings bound."""
    return lambda g: solve_pose_graph(g, max_iterations, init_lambda)
