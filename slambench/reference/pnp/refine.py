"""Pose-only Gauss-Newton refinement, and the unrolled Cholesky solver.

Port of kbslam/pnp/refine.py. Every function broadcasts over leading
batch dimensions: the reference's ``vmap`` over RANSAC hypotheses is a
batch dimension here, and its ``fori_loop`` a Python loop.
"""
from __future__ import annotations

import torch

from slambench.reference.geom.camera import Intrinsics, project
from slambench.reference.geom.se3 import SE3, cross_matrix


def chol_factor(H: torch.Tensor) -> dict:
    """Fully unrolled Cholesky factor of SPD [..., n, n] (static n), as a
    dict of per-entry [...] tensors — the reference's numerics, not
    ``torch.linalg.cholesky``'s."""
    n = H.shape[-1]
    L = {"n": n}
    for i in range(n):
        s = H[..., i, i] - sum(L[i, k] * L[i, k] for k in range(i))
        di = torch.sqrt(torch.clamp(s, min=1e-12))
        L[i, i] = di
        L["inv", i] = 1.0 / di
        for j in range(i + 1, n):
            s2 = H[..., j, i] - sum(L[j, k] * L[i, k] for k in range(i))
            L[j, i] = s2 * L["inv", i]
    return L


def chol_apply(L: dict, g: torch.Tensor) -> torch.Tensor:
    """Solve L L^T x = g given a chol_factor result; g is [..., n]."""
    n = L["n"]
    y = [None] * n
    for i in range(n):
        y[i] = (g[..., i] - sum(L[i, k] * y[k] for k in range(i))) * L["inv", i]
    x = [None] * n
    for i in reversed(range(n)):
        x[i] = (y[i] - sum(L[k, i] * x[k] for k in range(i + 1, n))) * L["inv", i]
    return torch.stack(x, dim=-1)


def chol_solve6(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve SPD [..., 6, 6] systems (see chol_factor)."""
    return chol_apply(chol_factor(H), g)


def _batched(T: SE3) -> SE3:
    """A pose [..., 4] / [..., 3] that broadcasts against points [..., N, 3]."""
    return SE3(T.q[..., None, :], T.t[..., None, :])


def reprojection_residuals(T_cw: SE3, points3d, uv_obs, intr: Intrinsics):
    """Residuals r = proj(T_cw X) - uv [..., N, 2], camera z [..., N] and
    camera-frame points [..., N, 3]."""
    pc = _batched(T_cw).apply(points3d)
    uv, z = project(intr, pc)
    return uv - uv_obs, z, pc


def pose_jacobian(pc: torch.Tensor, intr: Intrinsics) -> torch.Tensor:
    """d(residual)/d(xi) for left-multiplied xi = [dt, dw]: [..., N, 2, 6]."""
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    z = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    inv_z = 1.0 / z
    inv_z2 = inv_z * inv_z
    fx, fy = intr.fx, intr.fy
    zero = torch.zeros_like(x)
    J_proj = torch.stack([
        torch.stack([fx * inv_z, zero, -fx * x * inv_z2], dim=-1),
        torch.stack([zero, fy * inv_z, -fy * y * inv_z2], dim=-1),
    ], dim=-2)                                            # [..., N, 2, 3]
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device)
    J_pc = torch.cat([eye.expand(pc.shape[:-1] + (3, 3)), -cross_matrix(pc)],
                     dim=-1)                              # [..., N, 3, 6]
    return J_proj @ J_pc


def _gn_update(T: SE3, r, z, pc, w, intr, damping, per_row: bool = False):
    """One damped GN step on weights w [..., N]; keeps T where the step
    is not finite. ``per_row`` takes the gradient of each pose of a
    [S] batch in its own product, the one the unbatched pose takes (a
    batched one adds in another order on the CPU)."""
    ww = w * (z > 1e-6)
    J = pose_jacobian(pc, intr)
    Jw = J * ww[..., None, None]
    eye = torch.eye(6, dtype=T.t.dtype, device=T.t.device)
    H = torch.einsum("...nij,...nik->...jk", Jw, J) + damping * eye
    if per_row:
        g = torch.stack([torch.einsum("nij,ni->j", a, b)
                         for a, b in zip(Jw, r)])
    else:
        g = torch.einsum("...nij,...ni->...j", Jw, r)
    delta = -chol_solve6(H, g)
    T_new = SE3.exp(delta).compose(T).normalize()
    ok = torch.all(torch.isfinite(delta), dim=-1, keepdim=True)
    return SE3(torch.where(ok, T_new.q, T.q), torch.where(ok, T_new.t, T.t))


def refine_pose(T_init: SE3, points3d: torch.Tensor, uv_obs: torch.Tensor,
                weights: torch.Tensor, intr: Intrinsics, iters: int = 10,
                damping: float = 1e-6) -> SE3:
    """Weighted Gauss-Newton; T [..., 4]/[..., 3], points [..., N, 3],
    uv [..., N, 2], weights [..., N] (broadcastable)."""
    T = T_init
    for _ in range(iters):
        r, z, pc = reprojection_residuals(T, points3d, uv_obs, intr)
        T = _gn_update(T, r, z, pc, weights, intr, damping)
    return T


def refine_pose_two_stage(T_init: SE3, points3d: torch.Tensor,
                          uv_obs: torch.Tensor, w_stage1: torch.Tensor,
                          valid: torch.Tensor, intr: Intrinsics, iters: int,
                          wide_thr2: float, tight_thr2: float = 4.0,
                          min_tight: int = 12, damping: float = 1e-6) -> SE3:
    """``iters`` GN iterations on w_stage1 (the RANSAC inlier mask), then
    ``iters`` more on the sub-``tight_thr2`` subset of the residuals at
    the stage boundary (the wide gate when fewer than ``min_tight``
    survive). A batch of S poses ([S, 4], points [S, N, 3]) refines
    each stream on its own correspondences."""
    T = T_init
    w = w_stage1
    per_row = T_init.q.ndim == 2
    for i in range(2 * iters):
        r, z, pc = reprojection_residuals(T, points3d, uv_obs, intr)
        if i == iters:
            err2 = torch.sum(r * r, dim=-1)
            tight = (err2 < tight_thr2) & (z > 0) & valid
            wide = (err2 < wide_thr2) & (z > 0) & valid
            enough = torch.sum(tight, dim=-1, keepdim=True) >= min_tight
            w = torch.where(enough, tight, wide).to(w_stage1.dtype)
        T = _gn_update(T, r, z, pc, w, intr, damping, per_row)
    return T
