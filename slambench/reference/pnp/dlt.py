"""Batched 6-point DLT PnP minimal solver.

Port of kbslam/pnp/dlt.py: Hartley-normalized [K, 12, 12] normal
matrices, the smallest eigenvector by regularized inverse iteration on
one unrolled Cholesky factor, and the Newton polar projection onto
SO(3) — kept as written (no ``eigh`` / ``svd``), so the numerics are the
reference's.
"""
from __future__ import annotations

import torch

from slambench.reference.geom.camera import Intrinsics
from slambench.reference.geom.rotation import det3, polar_rotation
from slambench.reference.pnp.refine import chol_apply, chol_factor


def normalized_rays(intr: Intrinsics, uv: torch.Tensor) -> torch.Tensor:
    """Pixels [..., 2] -> normalized image coords (x/z, y/z)."""
    return torch.stack([(uv[..., 0] - intr.cx) / intr.fx,
                        (uv[..., 1] - intr.cy) / intr.fy], dim=-1)


def solve_dlt(points3d: torch.Tensor, rays: torch.Tensor):
    """DLT pose from minimal sets: points3d [..., n, 3] (source frame),
    rays [..., n, 2] normalized coords -> (R [..., 3, 3], t [..., 3]),
    source -> camera. Degenerate sets give poses that score no inliers.
    """
    c3 = torch.mean(points3d, dim=-2, keepdim=True)
    d3 = points3d - c3
    s3 = torch.mean(torch.linalg.vector_norm(d3, dim=-1), dim=-1)[..., None, None] + 1e-12
    Xn = d3 / s3

    c2 = torch.mean(rays, dim=-2, keepdim=True)
    d2 = rays - c2
    s2 = torch.mean(torch.linalg.vector_norm(d2, dim=-1), dim=-1)[..., None, None] + 1e-12
    xn_r = d2 / s2

    ones = torch.ones(Xn.shape[:-1] + (1,), dtype=Xn.dtype, device=Xn.device)
    Xh = torch.cat([Xn, ones], dim=-1)                   # [..., n, 4]
    zeros = torch.zeros_like(Xh)
    xn = xn_r[..., 0:1]
    yn = xn_r[..., 1:2]
    row_u = torch.cat([Xh, zeros, -xn * Xh], dim=-1)     # [..., n, 12]
    row_v = torch.cat([zeros, Xh, -yn * Xh], dim=-1)
    A = torch.cat([row_u, row_v], dim=-2)                # [..., 2n, 12]

    AtA = torch.einsum("...ni,...nj->...ij", A, A)
    # smallest eigenvector: factor (AtA + eps I) once, iterate v <- solve(v)
    tr = torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1)
    eps = (1e-6 / 12.0) * tr + 1e-12
    eye = torch.eye(12, dtype=AtA.dtype, device=AtA.device)
    L = chol_factor(AtA + eps[..., None, None] * eye)
    v = torch.ones(AtA.shape[:-2] + (12,), dtype=AtA.dtype, device=AtA.device)
    for _ in range(3):
        v = chol_apply(L, v)
        v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-30)
    Pn = v.reshape(v.shape[:-1] + (3, 4))

    # denormalize: P = N^-1 @ Pn @ T, where x' = N x_h, X' = T X_h
    batch = Pn.shape[:-2]
    s2s = s2[..., 0, 0]
    s3s = s3[..., 0, 0]
    N_inv = torch.zeros(batch + (3, 3), dtype=Pn.dtype, device=Pn.device)
    N_inv[..., 0, 0] = s2s
    N_inv[..., 1, 1] = s2s
    N_inv[..., 0, 2] = c2[..., 0, 0]
    N_inv[..., 1, 2] = c2[..., 0, 1]
    N_inv[..., 2, 2] = 1.0
    inv_s3 = 1.0 / s3s
    T4 = torch.zeros(batch + (4, 4), dtype=Pn.dtype, device=Pn.device)
    T4[..., 0, 0] = inv_s3
    T4[..., 1, 1] = inv_s3
    T4[..., 2, 2] = inv_s3
    T4[..., 0, 3] = -c3[..., 0, 0] * inv_s3
    T4[..., 1, 3] = -c3[..., 0, 1] * inv_s3
    T4[..., 2, 3] = -c3[..., 0, 2] * inv_s3
    T4[..., 3, 3] = 1.0
    P = N_inv @ Pn @ T4

    M = P[..., :, :3]
    detM = det3(M)
    lam = torch.sign(detM) * torch.abs(detM) ** (1.0 / 3.0)
    lam = torch.where(torch.abs(lam) < 1e-12, 1e-12, lam)
    R0 = M / lam[..., None, None]
    t = P[..., :, 3] / lam[..., None]
    # det(R0) > 0 by the sign of lam, so the polar factor is the closest
    # rotation
    return polar_rotation(R0), t
