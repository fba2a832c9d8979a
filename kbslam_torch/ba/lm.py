"""Dense reference Levenberg-Marquardt with an explicit Schur complement.

Port of kbslam/ba/lm.py, the direct restatement of the reference's LM +
SPARSE_SCHUR solve (Optimizers.cpp:201-213) on the full [W, F]
observation layout and the full [P] landmark ring. Production local BA
uses the compact formulation (``compact.py`` + ``compact_lm.py``, the
same objective); this module is the independent formulation that the
compact solver is held against, on the CPU and on the card.

The same residuals and robust weights as the reference (Huber times the
construction-time depth loss scale, plus the whitened depth rows when
``cfg.depth_residuals``), the depth-prior anchor, multiplicative damping
of both diagonals, the gauge (the newest window camera is held) and the
accept/reject rule. The normal equations are rebuilt from the current
state in every trip.

Three changes from the reference, none to its iterates:

- the sums into H_pp, b_p and the [P, W, 6, 3] coupling U are segment
  sums over ids sorted once per solve (``ops.incidence.SumById``) in
  place of ``.at[].add(mode="drop")``: they add in a fixed order, so a
  solve repeats bit for bit on the card (an ``index_add_`` would not);
  ids equal to P (inactive slots) are dropped as the reference drops
  them;
- the reference's ``fori_loop`` is a Python loop of ``cfg.max_iterations``
  trips whose updates after ``done`` are masked by ``torch.where``;
- the 6W x 6W reduced system is solved by ``torch.linalg.solve_ex``
  without its error check (``solve`` checks on the host).

No trip reads the device from the host. The solve runs on the device of
its inputs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from kbslam_torch.ba.compact_lm import block_diag, inv3x3
from kbslam_torch.ba.problem import BAProblem
from kbslam_torch.geom.camera import Intrinsics
from kbslam_torch.geom.se3 import SE3, cross_matrix, quat_conj, quat_to_matrix
from kbslam_torch.ops.incidence import SumById, incidence_gather

_EPS_Z = 1e-8


class BASolution(NamedTuple):
    cam_q: torch.Tensor         # [W, 4]
    cam_t: torch.Tensor         # [W, 3]
    mp_pos: torch.Tensor        # [P, 3]
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    iterations: torch.Tensor    # [] int32


def _project_terms(cam_q, cam_t, mp_pos, prob: BAProblem, intr: Intrinsics):
    """Common per-observation quantities for cost and Jacobians."""
    X = incidence_gather(torch.clamp(prob.mp_id, min=0).reshape(-1),
                         mp_pos).reshape(prob.mp_id.shape + (3,))
    pc = SE3(cam_q[:, None, :], cam_t[:, None, :]).inverse().apply(X)
    z = torch.clamp(pc[..., 2], min=_EPS_Z)  # functor clamp (Optimizers.hpp:32)
    u = intr.fx * pc[..., 0] / z + intr.cx
    v = intr.fy * pc[..., 1] / z + intr.cy
    r = torch.stack([u, v], dim=-1) - prob.obs_uv             # [W, F, 2]
    return X, pc, z, r


def _huber_terms(r, prob: BAProblem, cfg):
    """IRLS weight and robust cost per observation (Huber on the residual
    norm, scaled by the construction-time depth weight)."""
    n2 = torch.sum(r * r, dim=-1)
    n = torch.sqrt(torch.clamp(n2, min=1e-18))
    d = cfg.huber_delta
    active = prob.active.to(torch.float32)
    w_huber = torch.clamp(d / n, max=1.0)
    rho = torch.where(n <= d, n2, 2.0 * d * n - d * d)
    cost = torch.sum(prob.w_z * rho * active)
    return prob.w_z * w_huber * active, cost


def _depth_terms(z, prob: BAProblem, cfg):
    """The RGB-D depth row: residual z_cam - z_meas, its IRLS weight
    w_d * huber'(whitened) and its robust cost; w_d is 1/sigma^2 and zero
    for gated, missing or disabled rows."""
    r_z = z - prob.z_meas
    rw = torch.abs(torch.sqrt(prob.w_d) * r_z)
    d = cfg.huber_delta
    active = prob.active.to(torch.float32)
    w_hub = torch.clamp(d / torch.clamp(rw, min=1e-18), max=1.0)
    rho = torch.where(rw <= d, rw * rw, 2.0 * d * rw - d * d)
    return r_z, prob.w_d * w_hub * active, torch.sum(rho * active)


def _anchor_terms(cam_q, cam_t, mp_pos, prob: BAProblem, cfg):
    """Depth-prior residual r_d = (1/sigma) (z_cam0(X_a) - z0)."""
    has = prob.anchor_mp >= 0
    Xa = mp_pos.index_select(0, torch.clamp(prob.anchor_mp, min=0).reshape(1)
                             .to(torch.int64))[0]
    cam = prob.anchor_cam.reshape(1)
    q0 = cam_q.index_select(0, cam)[0]
    t0 = cam_t.index_select(0, cam)[0]
    R_cw0 = quat_to_matrix(quat_conj(q0))
    pc = R_cw0 @ (Xa - t0)
    sqrt_w = 1.0 / cfg.depth_prior_sigma
    r_d = torch.where(has, sqrt_w * (pc[2] - prob.anchor_z0), 0.0)
    return has, Xa, R_cw0, r_d, sqrt_w


def _total_cost(cam_q, cam_t, mp_pos, prob, intr, cfg):
    _, _, z, r = _project_terms(cam_q, cam_t, mp_pos, prob, intr)
    _, cost = _huber_terms(r, prob, cfg)
    if cfg.depth_residuals:
        cost = cost + _depth_terms(z, prob, cfg)[2]
    r_d = _anchor_terms(cam_q, cam_t, mp_pos, prob, cfg)[3]
    return cost + r_d * r_d


def solve_window(prob: BAProblem, mp_pos0: torch.Tensor, intr: Intrinsics,
                 cfg) -> BASolution:
    W, F = prob.mp_id.shape
    P = mp_pos0.shape[0]
    dev = mp_pos0.device

    widx = torch.arange(W, device=dev)
    cam_free = prob.real & (widx != prob.fixed_cam)
    maskc = cam_free.to(torch.float32)
    eye_mask = maskc[:, None].expand(W, 6).reshape(-1)
    oh_c = (widx == prob.anchor_cam).to(torch.float32)
    oh_p = torch.arange(P, device=dev) == prob.anchor_mp
    p_active = ((prob.inlier_obs > 0) | oh_p).to(torch.float32)

    # the sums by landmark and by (landmark, camera), planned once; an
    # inactive slot's id is P (dropped)
    obs_p = torch.where(prob.active, prob.mp_id.to(torch.int64), P)
    sum_p = SumById(obs_p.reshape(-1), P)
    sum_pw = SumById((obs_p * W + widx[:, None]).reshape(-1), P * W)

    def normal_equations(cam_q, cam_t, mp_pos):
        X, pc, z, r = _project_terms(cam_q, cam_t, mp_pos, prob, intr)
        w_irls, _ = _huber_terms(r, prob, cfg)

        # d(uv)/d(pc) [W, F, 2, 3]
        inv_z = 1.0 / z
        inv_z2 = inv_z * inv_z
        zero = torch.zeros_like(z)
        J_proj = torch.stack([
            torch.stack([intr.fx * inv_z, zero, -intr.fx * pc[..., 0] * inv_z2],
                        -1),
            torch.stack([zero, intr.fy * inv_z, -intr.fy * pc[..., 1] * inv_z2],
                        -1),
        ], dim=-2)
        w_rows = torch.stack([w_irls, w_irls], dim=-1)       # [W, F, R]
        if cfg.depth_residuals:
            # the depth row: d(z_cam)/d(pc) = (0, 0, 1)
            r_z, w_irls_d, _ = _depth_terms(z, prob, cfg)
            row_z = torch.stack([zero, zero, torch.ones_like(z)], -1)
            J_proj = torch.cat([J_proj, row_z[..., None, :]], dim=-2)
            r = torch.cat([r, r_z[..., None]], dim=-1)
            w_rows = torch.cat([w_rows, w_irls_d[..., None]], dim=-1)
        R_cw = quat_to_matrix(quat_conj(cam_q))               # [W, 3, 3]
        # d(pc)/d(delta_cam) for the left update T <- exp(d) T:
        # [-R_cw | R_cw [X]x]; d(pc)/dX = R_cw
        J_pt = torch.einsum("wfab,wbc->wfac", J_proj, R_cw)   # [W, F, R, 3]
        J_cam = torch.cat(
            [-J_pt, torch.einsum("wfab,wfbc->wfac", J_pt, cross_matrix(X))],
            dim=-1)                                           # [W, F, R, 6]

        H_cc = torch.einsum("wfri,wfr,wfrj->wij", J_cam, w_rows, J_cam)
        b_c = -torch.einsum("wfri,wfr,wfr->wi", J_cam, w_rows, r)
        Hp_obs = torch.einsum("wfri,wfr,wfrj->wfij", J_pt, w_rows, J_pt)
        bp_obs = -torch.einsum("wfri,wfr,wfr->wfi", J_pt, w_rows, r)
        U_obs = torch.einsum("wfri,wfr,wfrj->wfij", J_cam, w_rows, J_pt)

        lm_acc = sum_p(torch.cat([Hp_obs.reshape(W * F, 9),
                                  bp_obs.reshape(W * F, 3)], 1), exact=True)
        H_pp = lm_acc[:, :9].reshape(P, 3, 3)
        b_p = lm_acc[:, 9:]
        U = sum_pw(U_obs.reshape(W * F, 18), exact=True).reshape(P, W, 6, 3)

        # the depth prior on the anchor (Optimizers.cpp:181-189)
        has, Xa, R_cw0, r_d, sqrt_w = _anchor_terms(cam_q, cam_t, mp_pos,
                                                    prob, cfg)
        Jd_pt = sqrt_w * R_cw0[2]                             # [3]
        Jd_cam = sqrt_w * torch.cat([-R_cw0[2],
                                     (R_cw0 @ cross_matrix(Xa))[2]])
        hasf = has.to(torch.float32)
        at_p = hasf * oh_p.to(torch.float32)
        H_cc = H_cc + hasf * oh_c[:, None, None] * torch.outer(Jd_cam, Jd_cam)
        b_c = b_c - hasf * oh_c[:, None] * (Jd_cam * r_d)
        H_pp = H_pp + at_p[:, None, None] * torch.outer(Jd_pt, Jd_pt)
        b_p = b_p - at_p[:, None] * (Jd_pt * r_d)
        U = U + ((at_p[:, None] * oh_c[None, :])[:, :, None, None]
                 * torch.outer(Jd_cam, Jd_pt))
        return H_cc, b_c, H_pp, b_p, U

    def damp(H, lam):
        # multiplicative on the diagonals, Ceres-style
        d = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), 1e-8, 1e32)
        return H + lam * torch.diag_embed(d)

    def lm_step(cam_q, cam_t, mp_pos, lam, cost, it, done):
        H_cc, b_c, H_pp, b_p, U = normal_equations(cam_q, cam_t, mp_pos)
        Hpp_inv = inv3x3(damp(H_pp, lam)) * p_active[:, None, None]

        # zero coupling and state for frozen cameras (gauge and padding)
        U_m = U * maskc[None, :, None, None]
        b_c_m = b_c * maskc[:, None]

        # the reduced camera system S [6W, 6W]; identity rows and columns
        # for frozen cameras keep it well posed
        UH = torch.einsum("pwak,pkl->pwal", U_m, Hpp_inv)
        S = (-torch.einsum("pwal,pvbl->wavb", UH, U_m)).reshape(W * 6, W * 6) \
            + block_diag(damp(H_cc, lam))
        S = S * eye_mask[:, None] * eye_mask[None, :] + torch.diag(1.0 - eye_mask)
        b_tilde = b_c_m - torch.einsum("pwal,pl->wa", UH, b_p)
        delta_c = torch.linalg.solve_ex(
            S, (b_tilde * maskc[:, None]).reshape(-1)).result
        delta_c = delta_c.reshape(W, 6) * maskc[:, None]

        # landmarks by back-substitution
        rhs = b_p - torch.einsum("pwak,wa->pk", U_m, delta_c)
        delta_p = torch.einsum("pkl,pl->pk", Hpp_inv, rhs) * p_active[:, None]

        T_new = SE3.exp(delta_c).compose(SE3(cam_q, cam_t)).normalize()
        cam_q_t = torch.where(cam_free[:, None], T_new.q, cam_q)
        cam_t_t = torch.where(cam_free[:, None], T_new.t, cam_t)
        mp_t = mp_pos + delta_p

        new_cost = _total_cost(cam_q_t, cam_t_t, mp_t, prob, intr, cfg)
        finite = torch.isfinite(new_cost) & torch.all(torch.isfinite(delta_c))
        accept = finite & (new_cost < cost) & ~done

        cam_q = torch.where(accept, cam_q_t, cam_q)
        cam_t = torch.where(accept, cam_t_t, cam_t)
        mp_pos = torch.where(accept, mp_t, mp_pos)
        cost_out = torch.where(accept, new_cost, cost)
        lam_next = torch.clamp(
            torch.where(accept, lam * cfg.lm_lambda_down, lam * cfg.lm_lambda_up),
            cfg.lm_min_lambda, cfg.lm_max_lambda)
        lam = torch.where(done, lam, lam_next)
        # converged: an accepted step with a tiny relative improvement, or
        # the damping saturated; later trips are masked no-ops
        rel = torch.abs(cost - cost_out) / torch.clamp(cost, min=1e-12)
        done = done | (accept & (rel < 1e-6)) | (lam >= cfg.lm_max_lambda)
        it = torch.where(done, it, it + 1)
        return cam_q, cam_t, mp_pos, lam, cost_out, it, done

    cost0 = _total_cost(prob.cam_q, prob.cam_t, mp_pos0, prob, intr, cfg)
    carry = (prob.cam_q, prob.cam_t, mp_pos0,
             torch.full((), cfg.lm_init_lambda, dtype=torch.float32,
                        device=dev),
             cost0, torch.zeros((), dtype=torch.int32, device=dev),
             torch.zeros((), dtype=torch.bool, device=dev))
    for _ in range(cfg.max_iterations):
        carry = lm_step(*carry)
    cam_q, cam_t, mp_pos, _, cost, it, _ = carry
    return BASolution(cam_q, cam_t, mp_pos, cost0, cost, it)
