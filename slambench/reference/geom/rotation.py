"""SO(3) projection and 3x3 helpers in closed form.

Port of kbslam/geom/rotation.py. The closest rotation comes from the
scaled Newton polar iteration, not an SVD, so the numerics match the
reference's: when det(M) < 0 the iteration converges to a reflection,
which RANSAC scores at zero inliers.
"""
from __future__ import annotations

import torch


def det3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form determinant of [..., 3, 3]."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def adjugate3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate (transposed cofactors) of [..., 3, 3]."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    row0 = torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], dim=-1)
    row1 = torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], dim=-1)
    row2 = torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def inv_transpose3(M: torch.Tensor) -> torch.Tensor:
    """M^-T for [..., 3, 3] via adjugate / det."""
    det = det3(M)
    safe = torch.where(torch.abs(det) < 1e-20, 1e-20, det)
    return adjugate3(M).transpose(-1, -2) / safe[..., None, None]


def polar_rotation(M: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """Orthogonal polar factor of [..., 3, 3] by the scaled Newton
    iteration X <- 0.5 (g X + (g X)^-T), g = |det X|^(-1/3)."""
    nrm = torch.sqrt(torch.sum(M * M, dim=(-2, -1), keepdim=True)) + 1e-20
    X = M / nrm
    for _ in range(iters):
        d = torch.abs(det3(X))
        g = torch.where(d < 1e-20, 1.0, d ** (-1.0 / 3.0))[..., None, None]
        Xg = X * g
        X = 0.5 * (Xg + inv_transpose3(Xg))
    return X
