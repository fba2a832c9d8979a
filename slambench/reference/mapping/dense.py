"""TSDF fusion of one depth image, as plain eager torch, frozen from the
port (``kbslam_torch/mapping/dense.py``: ``integrate``) for the
benchmark's reference.

Every voxel centre is moved into the camera, projected, and reads the
depth image at its rounded pixel (one nearest-neighbour gather); the
clamped signed distance is averaged into the voxel with weight one
where the voxel is observed (in front of the surface, or within the
truncation band behind it). ``torch.round`` rounds half to even.

Departure from the program: ``integrate`` fuses the x rows
``[x0, x0 + nx)`` of a volume (a slab), so that on the card a 512^3
slot is fused a slab at a time beside the program's memory; a voxel's
update reads nothing but its own centre and the depth image, and its
centre comes from the same expression of its global x index, so a slab
equals those rows of the whole volume. ``projection`` gives a slab's
pixel coordinates and depths for the check's rounding-edge rule.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from slambench.reference.geom.camera import Intrinsics, distort_points
from slambench.reference.geom.se3 import SE3


class TSDFState(NamedTuple):
    tsdf: torch.Tensor     # [nx, ny, nz] f32 in [-1, 1] (units of truncation)
    weight: torch.Tensor   # [nx, ny, nz] f32 accumulated observation weight


def empty_tsdf(dims, device) -> TSDFState:
    return TSDFState(torch.ones(tuple(dims), dtype=torch.float32,
                                device=device),
                     torch.zeros(tuple(dims), dtype=torch.float32,
                                 device=device))


def voxel_centers(cfg, device, x0: int, nx: int) -> torch.Tensor:
    """[V, 3] positions of the centres of the voxels with x index in
    [x0, x0 + nx), in the volume's frame."""
    axes = [(torch.arange(a, a + n, dtype=torch.float32, device=device)
             + 0.5) * cfg.voxel_size + o
            for a, n, o in zip((x0, 0, 0), (nx,) + tuple(cfg.dims[1:]),
                               cfg.origin)]
    grid = torch.meshgrid(*axes, indexing="ij")
    return torch.stack(grid, dim=-1).reshape(-1, 3)


def projection(cfg, intr: Intrinsics, pose: SE3, x0: int, nx: int,
               width: int, height: int):
    """(u [V], v [V], z [V], inside [V]) of the slab's voxel centres seen
    from camera-to-volume ``pose``: pixel coordinates before rounding,
    depth along the axis, and whether the voxel lies in front of the
    camera and rounds into the image."""
    X = voxel_centers(cfg, pose.q.device, x0, nx)
    Xc = pose.inverse().apply(X)
    z = Xc[:, 2]
    zs = torch.where(z > 0, z, 1.0)
    u = intr.fx * Xc[:, 0] / zs + intr.cx
    v = intr.fy * Xc[:, 1] / zs + intr.cy
    inside = z > cfg.min_depth
    if intr.has_distortion:
        xn = (u - intr.cx) / intr.fx
        yn = (v - intr.cy) / intr.fy
        r2_corner = (((width / 2.0) / intr.fx) ** 2
                     + ((height / 2.0) / intr.fy) ** 2)
        inside = inside & ((xn * xn + yn * yn) <= 2.25 * r2_corner)
        uv = distort_points(intr, torch.stack([u, v], dim=-1))
        u, v = uv[..., 0], uv[..., 1]
    ui = _rounded_index(u, width)
    vi = _rounded_index(v, height)
    inside = inside & (ui >= 0) & (ui < width) & (vi >= 0) & (vi < height)
    return u, v, z, inside


def _rounded_index(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.round(x).clamp(-1, n).to(torch.int64)


def integrate(state: TSDFState, depth_m: torch.Tensor, pose: SE3,
              intr: Intrinsics, cfg, x0: int = 0) -> TSDFState:
    """Fuse one metric depth image [H, W] taken at camera-to-volume
    ``pose`` into ``state``, the x rows of the volume from ``x0`` on;
    returns new tensors."""
    H, W = depth_m.shape
    shape = state.tsdf.shape
    u, v, z, inside = projection(cfg, intr, pose, x0, shape[0], W, H)
    ui = _rounded_index(u, W)
    vi = _rounded_index(v, H)
    flat = vi.clamp(0, H - 1) * W + ui.clamp(0, W - 1)
    d = torch.nan_to_num(depth_m.reshape(-1)[flat], nan=0.0)
    depth_ok = (d > cfg.min_depth) & (d < cfg.max_depth)
    sdf = d - z
    observed = inside & depth_ok & (sdf > -cfg.truncation)
    tsdf_new = torch.clamp(sdf / cfg.truncation, -1.0, 1.0)
    w_new = observed.to(torch.float32)
    t_old = state.tsdf.reshape(-1)
    w_old = state.weight.reshape(-1)
    w_sum = w_old + w_new
    t = torch.where(w_sum > 0, (t_old * w_old + tsdf_new * w_new)
                    / torch.clamp_min(w_sum, 1.0), t_old)
    w = torch.clamp_max(w_sum, cfg.max_weight)
    return TSDFState(t.reshape(shape), w.reshape(shape))
