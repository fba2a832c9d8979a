"""Pinhole camera: projection, depth unprojection, lens distortion.

Port of kbslam/geom/camera.py. ``Intrinsics`` is the port's own
NamedTuple of host floats, with the same fields and constructors as the
reference's (which cannot be imported without JAX).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Intrinsics(NamedTuple):
    """Pinhole intrinsics as host floats, plus the 5-vector Brown-Conrady
    distortion (k1, k2, p1, p2, k3); all zero = rectified input."""

    fx: float
    fy: float
    cx: float
    cy: float
    dist: tuple = (0.0, 0.0, 0.0, 0.0, 0.0)

    @property
    def has_distortion(self) -> bool:
        return any(c != 0.0 for c in self.dist)

    @staticmethod
    def from_matrix(K, dist=None) -> "Intrinsics":
        K = np.asarray(K)
        if dist is not None:
            dv = np.asarray(dist).ravel()
            if len(dv) > 5 and np.any(dv[5:]):
                raise ValueError(
                    f"unsupported distortion model: got {len(dv)} "
                    "coefficients with nonzero tail; only the 5-vector "
                    "Brown-Conrady (k1,k2,p1,p2,k3) is supported")
            d = tuple(float(c) for c in dv[:5])
        else:
            d = (0.0,) * 5
        d = d + (0.0,) * (5 - len(d))
        return Intrinsics(float(K[0, 0]), float(K[1, 1]),
                          float(K[0, 2]), float(K[1, 2]), d)

    @staticmethod
    def create(fx, fy, cx, cy, dist=(0.0,) * 5) -> "Intrinsics":
        return Intrinsics(float(fx), float(fy), float(cx), float(cy),
                          tuple(float(c) for c in dist))

    def matrix(self, device=None) -> torch.Tensor:
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=torch.float32, device=device)


def project(intr: Intrinsics, points_cam: torch.Tensor, eps: float = 1e-9):
    """Camera-frame points [..., 3] -> (pixels [..., 2], depth z [...]);
    the caller masks on z > 0."""
    z = points_cam[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < eps, eps, z)
    u = intr.fx * points_cam[..., 0] * inv_z + intr.cx
    v = intr.fy * points_cam[..., 1] * inv_z + intr.cy
    return torch.stack([u, v], dim=-1), z


def unproject(intr: Intrinsics, uv: torch.Tensor,
              depth_m: torch.Tensor) -> torch.Tensor:
    """Pixels [..., 2] + metric depth [...] -> camera-frame points [..., 3]."""
    x = (uv[..., 0] - intr.cx) * depth_m / intr.fx
    y = (uv[..., 1] - intr.cy) * depth_m / intr.fy
    return torch.stack([x, y, depth_m], dim=-1)


def distort_points(intr: Intrinsics, uv: torch.Tensor) -> torch.Tensor:
    """Rectified pixels [..., 2] -> distorted pixels (forward model)."""
    k1, k2, p1, p2, k3 = intr.dist
    x = (uv[..., 0] - intr.cx) / intr.fx
    y = (uv[..., 1] - intr.cy) / intr.fy
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([intr.fx * xd + intr.cx, intr.fy * yd + intr.cy],
                       dim=-1)


def undistort_points(intr: Intrinsics, uv: torch.Tensor,
                     iters: int = 8) -> torch.Tensor:
    """Distorted pixels [..., 2] -> rectified pixels by the fixed-point
    iteration of cv::undistortPoints (8 fixed iterations)."""
    k1, k2, p1, p2, k3 = intr.dist
    xd = (uv[..., 0] - intr.cx) / intr.fx
    yd = (uv[..., 1] - intr.cy) / intr.fy
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        inv = 1.0 / radial
        x = (xd - dx) * inv
        y = (yd - dy) * inv
    return torch.stack([intr.fx * x + intr.cx, intr.fy * y + intr.cy],
                       dim=-1)


def depth_at(depth: torch.Tensor, uv: torch.Tensor,
             depth_scale: float) -> torch.Tensor:
    """Sample a depth image ([H, W], raw sensor units widened to int32 —
    or float32 holding integers) at rounded pixel coords -> metres.

    ``torch.round`` rounds half to even, like ``jnp.round``, so the
    pixel a keypoint reads is the reference's. Out-of-bounds coords
    clamp."""
    h, w = depth.shape[-2:]
    u = torch.clamp(torch.round(uv[..., 0]).to(torch.int64), 0, w - 1)
    v = torch.clamp(torch.round(uv[..., 1]).to(torch.int64), 0, h - 1)
    if depth.ndim == 2:
        d = depth[v, u]
    else:
        flat = depth.reshape(depth.shape[:-2] + (-1,))
        d = torch.gather(flat, -1, v * w + u)
    return d.to(torch.float32) * depth_scale


def to_display_coords(p: torch.Tensor) -> torch.Tensor:
    """The display-coordinate remap of the reference's viewer path,
    (x, y, z) -> (x, -z, -y) on the last axis (Map.cpp:86,96;
    VisualOdometry.cpp:181)."""
    return torch.stack([p[..., 0], -p[..., 2], -p[..., 1]], dim=-1)
