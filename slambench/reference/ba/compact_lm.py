"""Levenberg-Marquardt on the compact problem, with no host round trip.

Port of kbslam/ba/compact_lm.py: the same residuals and robust weights
(Huber times the depth loss scale, plus the whitened depth rows when
``cfg.depth_residuals``), the same gauge (the newest window camera is
held), the depth-prior anchor, and the same damped accept/reject loop
with the normal equations kept from the last accepted state. Sums by
camera, by landmark and by (landmark, camera) are segment sums of the
per-observation terms over plans made once per solve
(``ops.incidence.SumById``: the ids do not change across LM trips). They
add in a fixed order, so a solve repeats bit for bit and a replayed CUDA
graph of it equals the eager solve; results agree with the reference to
float32 rounding, not bit for bit.

Two changes make the solve run without reading the device from the host:

- each ``lax.cond`` of the reference computes both branches and selects
  with ``torch.where``;
- the reference's ``while_loop`` stops at ``done``; here the loop runs
  its full ``cfg.max_iterations`` trips, and every update after ``done``
  is masked, so the iterates are the reference's (its own trips after
  ``done`` are no-ops by construction).

The 6W x 6W reduced camera system is solved with ``torch.linalg.solve_ex``
without its error check (``solve`` checks on the host).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from slambench.reference.ba.compact import CompactProblem
from slambench.reference.ba.problem import BAProblem
from slambench.reference.geom.camera import Intrinsics
from slambench.reference.geom.se3 import SE3, cross_matrix, quat_conj, quat_to_matrix
from slambench.reference.ops.incidence import SumById, incidence_gather

_EPS_Z = 1e-8


class CompactSolution(NamedTuple):
    cam_q: torch.Tensor
    cam_t: torch.Tensor
    Xc: torch.Tensor            # [L, 3] optimized compact landmark positions
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    iterations: torch.Tensor    # [] int32
    accepted: torch.Tensor      # [] int32 LM steps that decreased the cost


def inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse by the adjugate (kbslam/ba/lm.py)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-20, 1e-20, det)
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], -1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], -1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], -1),
    ], dim=-2)
    return adj * inv_det[..., None, None]


def block_diag(blocks: torch.Tensor) -> torch.Tensor:
    """[W, k, k] -> [W*k, W*k] block diagonal (kbslam/ba/lm.py)."""
    W, k, _ = blocks.shape
    eye = torch.eye(W, dtype=torch.bool, device=blocks.device)
    return torch.where(eye[:, None, :, None], blocks[:, :, None, :],
                       0.0).reshape(W * k, W * k)


def _obs_terms(cam_q, cam_t, Xc, cp: CompactProblem, intr: Intrinsics, cfg):
    """Residuals, weights and Jacobian ingredients on the [O] observation
    axis. With cfg.depth_residuals each observation has a third row
    (z_cam - z_meas, sigma-whitened Huber); r and w are then [O, 3]."""
    W = cam_q.shape[0]
    R_cw = quat_to_matrix(quat_conj(cam_q))                   # [W, 3, 3]
    Rcw_o = incidence_gather(cp.obs_w, R_cw.reshape(W, 9)).reshape(-1, 3, 3)
    t_o = incidence_gather(cp.obs_w, cam_t)                   # [O, 3]
    X_o = incidence_gather(cp.obs_l, Xc)                      # [O, 3]

    pc = torch.einsum("oij,oj->oi", Rcw_o, X_o - t_o)
    z = torch.clamp(pc[:, 2], min=_EPS_Z)
    u = intr.fx * pc[:, 0] / z + intr.cx
    v = intr.fy * pc[:, 1] / z + intr.cy
    r = torch.stack([u, v], dim=-1) - cp.obs_uv               # [O, 2]

    valid = cp.obs_valid.to(torch.float32)
    n2 = torch.sum(r * r, dim=-1)
    n = torch.sqrt(torch.clamp(n2, min=1e-18))
    d = cfg.huber_delta
    w_irls = cp.obs_wz * torch.clamp(d / n, max=1.0) * valid
    rho = torch.where(n <= d, n2, 2.0 * d * n - d * d)
    cost = torch.sum(cp.obs_wz * rho * valid)
    w_rows = torch.stack([w_irls, w_irls], dim=-1)            # [O, R]
    if cfg.depth_residuals:
        r_z = z - cp.obs_zmeas
        rw = torch.abs(torch.sqrt(cp.obs_wd) * r_z)
        w_hub = torch.clamp(d / torch.clamp(rw, min=1e-18), max=1.0)
        rho_d = torch.where(rw <= d, rw * rw, 2.0 * d * rw - d * d)
        cost = cost + torch.sum(rho_d * valid)
        w_d_irls = cp.obs_wd * w_hub * valid
        r = torch.cat([r, r_z[:, None]], dim=-1)
        w_rows = torch.cat([w_rows, w_d_irls[:, None]], dim=-1)
    return r, z, pc, X_o, Rcw_o, w_rows, cost


def _anchor_terms(cam_q, cam_t, Xc, cp: CompactProblem, prob: BAProblem,
                  cfg):
    has = cp.anchor_l >= 0
    Xa = Xc.index_select(0, torch.clamp(cp.anchor_l, min=0).reshape(1)
                         .to(torch.int64))[0]
    cam = prob.anchor_cam.reshape(1)
    q0 = cam_q.index_select(0, cam)[0]
    t0 = cam_t.index_select(0, cam)[0]
    R_cw0 = quat_to_matrix(quat_conj(q0))
    pca = R_cw0 @ (Xa - t0)
    sqrt_w = 1.0 / cfg.depth_prior_sigma
    r_d = torch.where(has, sqrt_w * (pca[2] - prob.anchor_z0), 0.0)
    return has, Xa, R_cw0, r_d, sqrt_w


def _total_cost(cam_q, cam_t, Xc, cp, prob, intr, cfg):
    *_, cost = _obs_terms(cam_q, cam_t, Xc, cp, intr, cfg)
    _, _, _, r_d, _ = _anchor_terms(cam_q, cam_t, Xc, cp, prob, cfg)
    return cost + r_d * r_d


def _select(cond, a, b):
    return tuple(torch.where(cond, x, y) for x, y in zip(a, b))


def solve_window_compact(prob: BAProblem, cp: CompactProblem,
                         intr: Intrinsics, cfg) -> CompactSolution:
    W = prob.cam_q.shape[0]
    L = cp.Xc.shape[0]
    O = cp.obs_valid.shape[0]
    dev = cp.Xc.device

    widx = torch.arange(W, device=dev)
    cam_free = prob.real & (widx != prob.fixed_cam)
    maskc = cam_free.to(torch.float32)
    p_act = cp.l_valid.to(torch.float32)
    eye_mask = maskc[:, None].expand(W, 6).reshape(-1)
    oh_c = (widx == prob.anchor_cam).to(torch.float32)
    oh_l = (torch.arange(L, device=dev) == cp.anchor_l).to(torch.float32)

    # the three sums by id, planned once: by camera, by landmark and by
    # (landmark, camera), the U blocks
    sum_c = SumById(cp.obs_w, W)
    sum_l = SumById(cp.obs_l, L)
    sum_lw = SumById(torch.where(cp.obs_valid, cp.obs_l * W + cp.obs_w,
                                 L * W), L * W)

    def normal_equations(cam_q, cam_t, Xc):
        r, z, pc, X_o, Rcw_o, w, cost = _obs_terms(cam_q, cam_t, Xc, cp,
                                                   intr, cfg)
        inv_z = 1.0 / z
        zero = torch.zeros_like(z)
        J_proj = torch.stack([
            torch.stack([intr.fx * inv_z, zero,
                         -intr.fx * pc[:, 0] * inv_z * inv_z], -1),
            torch.stack([zero, intr.fy * inv_z,
                         -intr.fy * pc[:, 1] * inv_z * inv_z], -1),
        ], dim=-2)                                            # [O, 2, 3]
        if cfg.depth_residuals:
            # depth row: d(z_cam)/d(pc) = (0, 0, 1)
            row_z = torch.stack([zero, zero, torch.ones_like(z)], -1)
            J_proj = torch.cat([J_proj, row_z[:, None, :]], dim=-2)
        J_pt = torch.einsum("oab,obc->oac", J_proj, Rcw_o)
        J_cam = torch.cat(
            [-J_pt, torch.einsum("oab,obc->oac", J_pt, cross_matrix(X_o))],
            dim=-1)                                           # [O, R, 6]

        # camera side: W targets; w is per row
        Hcc_o = torch.einsum("ori,or,orj->oij", J_cam, w, J_cam).reshape(O, 36)
        bc_o = -torch.einsum("ori,or,or->oi", J_cam, w, r)
        cam_acc = sum_c(torch.cat([Hcc_o, bc_o], 1), exact=True)
        H_cc = cam_acc[:, :36].reshape(W, 6, 6)
        b_c = cam_acc[:, 36:]

        # landmark side: [L, 9 + 3]
        Hp_o = torch.einsum("ori,or,orj->oij", J_pt, w, J_pt).reshape(O, 9)
        bp_o = -torch.einsum("ori,or,or->oi", J_pt, w, r)
        lm_acc = sum_l(torch.cat([Hp_o, bp_o], 1), exact=True)
        H_pp = lm_acc[:, :9].reshape(L, 3, 3)
        b_p = lm_acc[:, 9:]

        # camera-landmark coupling: [L*W, 18] -> [L, W, 6, 3]
        U_o = torch.einsum("ori,or,orj->oij", J_cam, w, J_pt).reshape(O, 18)
        U = sum_lw(U_o, exact=True).reshape(L, W, 6, 3)

        # depth prior on the anchor
        has, Xa, R_cw0, r_d, sqrt_w = _anchor_terms(cam_q, cam_t, Xc, cp,
                                                    prob, cfg)
        Jd_pt = sqrt_w * R_cw0[2]
        Jd_cam = sqrt_w * torch.cat([-R_cw0[2], (R_cw0 @ cross_matrix(Xa))[2]])
        hasf = has.to(torch.float32)
        H_cc = H_cc + hasf * oh_c[:, None, None] * torch.outer(Jd_cam, Jd_cam)
        b_c = b_c - hasf * oh_c[:, None] * (Jd_cam * r_d)
        H_pp = H_pp + hasf * oh_l[:, None, None] * torch.outer(Jd_pt, Jd_pt)
        b_p = b_p - hasf * oh_l[:, None] * (Jd_pt * r_d)
        U = U + ((hasf * oh_l[:, None] * oh_c[None, :])[:, :, None, None]
                 * torch.outer(Jd_cam, Jd_pt)[None, None])
        return (H_cc, b_c, H_pp, b_p, U), cost + r_d * r_d

    def damp(H, lam):
        diag = torch.diagonal(H, dim1=-2, dim2=-1)
        d = torch.clamp(diag, 1e-8, 1e32)
        return H + lam * torch.diag_embed(d)

    def lm_step(cam_q, cam_t, Xc, lam, cost, ne, it, acc, done):
        H_cc, b_c, H_pp, b_p, U = ne
        Hpp_inv = inv3x3(damp(H_pp, lam)) * p_act[:, None, None]
        U_m = U * maskc[None, :, None, None]
        b_c_m = b_c * maskc[:, None]

        S = (-torch.einsum("lwak,lkm,lvbm->wavb", U_m, Hpp_inv, U_m)
             ).reshape(W * 6, W * 6) + block_diag(damp(H_cc, lam))
        S = S * eye_mask[:, None] * eye_mask[None, :] + torch.diag(1.0 - eye_mask)
        b_tilde = b_c_m - torch.einsum("lwak,lkm,lm->wa", U_m, Hpp_inv, b_p)
        delta_c = torch.linalg.solve_ex(
            S, (b_tilde * maskc[:, None]).reshape(-1)).result
        delta_c = delta_c.reshape(W, 6) * maskc[:, None]

        rhs = b_p - torch.einsum("lwak,wa->lk", U_m, delta_c)
        delta_p = torch.einsum("lkm,lm->lk", Hpp_inv, rhs) * p_act[:, None]

        T_new = SE3.exp(delta_c).compose(SE3(cam_q, cam_t)).normalize()
        cam_q_t = torch.where(cam_free[:, None], T_new.q, cam_q)
        cam_t_t = torch.where(cam_free[:, None], T_new.t, cam_t)
        Xc_t = Xc + delta_p

        new_cost = _total_cost(cam_q_t, cam_t_t, Xc_t, cp, prob, intr, cfg)
        finite = torch.isfinite(new_cost) & torch.all(torch.isfinite(delta_c))
        accept = finite & (new_cost < cost) & ~done

        if cfg.inner_iterations:
            # on accept, one Newton step on the landmark-only system
            # re-linearized at the new cameras, kept on strict descent
            # (Ceres' inner iterations); both branches are computed
            (_, _, H_pp2, b_p2, _), _ = normal_equations(cam_q_t, cam_t_t,
                                                         Xc_t)
            eye3 = torch.eye(3, device=dev)
            Hpp_inv2 = inv3x3(H_pp2 + 1e-8 * eye3) * p_act[:, None, None]
            Xc_i = Xc_t + torch.einsum("lkm,lm->lk", Hpp_inv2, b_p2) \
                * p_act[:, None]
            c_i = _total_cost(cam_q_t, cam_t_t, Xc_i, cp, prob, intr, cfg)
            ok = torch.isfinite(c_i) & (c_i < new_cost)
            Xc_t = torch.where(ok, Xc_i, Xc_t)
            new_cost = torch.where(ok, c_i, new_cost)
        # the normal equations at the proposal, kept only on accept
        ne_t, _ = normal_equations(cam_q_t, cam_t_t, Xc_t)

        cam_q = torch.where(accept, cam_q_t, cam_q)
        cam_t = torch.where(accept, cam_t_t, cam_t)
        Xc = torch.where(accept, Xc_t, Xc)
        cost_out = torch.where(accept, new_cost, cost)
        ne = _select(accept, ne_t, ne)
        lam_next = torch.clamp(
            torch.where(accept, lam * cfg.lm_lambda_down, lam * cfg.lm_lambda_up),
            cfg.lm_min_lambda, cfg.lm_max_lambda)
        lam = torch.where(done, lam, lam_next)
        rel = torch.abs(cost - cost_out) / torch.clamp(cost, min=1e-12)
        done = done | (accept & (rel < 1e-6)) | (lam >= cfg.lm_max_lambda)
        it = torch.where(done, it, it + 1)
        acc = acc + accept.to(torch.int32)
        return cam_q, cam_t, Xc, lam, cost_out, ne, it, acc, done

    ne, cost0 = normal_equations(prob.cam_q, prob.cam_t, cp.Xc)
    lam = torch.full((), cfg.lm_init_lambda, dtype=torch.float32, device=dev)
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    carry = (prob.cam_q, prob.cam_t, cp.Xc, lam, cost0, ne, zero_i, zero_i,
             torch.zeros((), dtype=torch.bool, device=dev))
    for _ in range(cfg.max_iterations):
        carry = lm_step(*carry)
    cam_q, cam_t, Xc, _, cost, _, it, acc, _ = carry
    return CompactSolution(cam_q, cam_t, Xc, cost0, cost, it, acc)
