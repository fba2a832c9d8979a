"""Dense TSDF volume: voxel-centric projective integration.

Port of kbslam/mapping/dense.py (the monolithic volume). The volume is a
fixed [Nx, Ny, Nz] float32 pair (tsdf, weight). ``integrate`` moves
every voxel center into the keyframe camera, projects it, reads the
depth image at the rounded pixel with one nearest-neighbour gather (not
bilinear: the truncation band swallows the sub-pixel difference) and
updates the running weighted average (Curless-Levoy) with ``where``
ops. It makes no host read, so it can run inside a CUDA graph and
between the replays of the chunk graph without a sync.

Parity with the reference: ``torch.round`` rounds half to even, as
``jnp.round`` does; ``torch.nan_to_num`` maps +inf to the largest
finite float, as ``jnp.nan_to_num`` does; Python scalars enter the
float32 ops as float32, as JAX's weak types do.

Like the reference's, the volume is not re-warped by loop-closure
corrections (a TSDF cannot be carried rigidly per keyframe): fuse again
offline from the corrected poses with ``integrate_sequence``.

Over a process group (``parallel.dist.ShardGroup``) the volume is split
into slabs of its leading (x) axis, one per rank (``shard_tsdf``); each
rank fuses its [nx/W, ny, nz] slab from its own copy of the depth image
and pose (``make_sharded_integrate``). A voxel's update reads nothing
but its own centre and the depth image, so fusion makes no collective,
and a slab's voxels equal the whole volume's bit for bit: their centres
come from the same expression of their global x index.
``gather_tsdf`` stacks the slabs back.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from kbslam_torch.config import DenseMapConfig
from kbslam_torch.device import pick_device
from kbslam_torch.geom.camera import Intrinsics, distort_points
from kbslam_torch.geom.se3 import SE3
from kbslam_torch.parallel.dist import ShardGroup, block_tree, gather_tree


class TSDFState(NamedTuple):
    tsdf: torch.Tensor     # [Nx, Ny, Nz] f32 in [-1, 1] (units of truncation)
    weight: torch.Tensor   # [Nx, Ny, Nz] f32 accumulated observation weight


def empty_tsdf(cfg: DenseMapConfig, device=None) -> TSDFState:
    dev = pick_device(device)
    return TSDFState(tsdf=torch.ones(cfg.dims, dtype=torch.float32, device=dev),
                     weight=torch.zeros(cfg.dims, dtype=torch.float32,
                                        device=dev))


def _voxel_centers(cfg: DenseMapConfig, device, x0: int,
                   nx: int) -> torch.Tensor:
    """[V, 3] world positions of the centers of the voxels with x index
    in [x0, x0 + nx), built on the device (no host copy, so the call can
    be captured)."""
    axes = [(torch.arange(a, a + n, dtype=torch.float32, device=device)
             + 0.5) * cfg.voxel_size + o
            for a, n, o in zip((x0, 0, 0), (nx,) + tuple(cfg.dims[1:]),
                               cfg.origin)]
    grid = torch.meshgrid(*axes, indexing="ij")
    return torch.stack(grid, dim=-1).reshape(-1, 3)


def _rounded_index(x: torch.Tensor, n: int) -> torch.Tensor:
    """round(x) as int64, clamped to [-1, n] first so that a far point
    stays outside [0, n) without an out-of-range float-to-int cast."""
    return torch.round(x).clamp(-1, n).to(torch.int64)


def integrate(state: TSDFState, depth_m: torch.Tensor, pose: SE3,
              intr: Intrinsics, cfg: DenseMapConfig,
              x0: int = 0) -> TSDFState:
    """Fuse one metric depth image taken at camera-to-world ``pose``.

    Projective TSDF: for each voxel center X, sdf = depth(pi(X_cam)) -
    z(X_cam), clamped to +-truncation and averaged into the volume where
    observed (in front of, or within the band behind, the surface).
    ``state`` is the whole volume or the slab of its x rows from ``x0``
    on."""
    H, W = depth_m.shape
    shape = state.tsdf.shape
    X = _voxel_centers(cfg, depth_m.device, x0, shape[0])    # [V, 3]
    Xc = pose.inverse().apply(X)                              # [V, 3]
    z = Xc[:, 2]
    zs = torch.where(z > 0, z, 1.0)
    u = intr.fx * Xc[:, 0] / zs + intr.cx
    v = intr.fy * Xc[:, 1] / zs + intr.cy
    inside = z > cfg.min_depth
    if intr.has_distortion:
        # depth lives in distorted pixel space: push the pinhole
        # projection through the forward model, gated to 1.5x the image
        # corner's radius, past which the polynomial folds far points
        # back into the image
        xn = (u - intr.cx) / intr.fx
        yn = (v - intr.cy) / intr.fy
        r2_corner = ((W / 2.0) / intr.fx) ** 2 + ((H / 2.0) / intr.fy) ** 2
        inside = inside & ((xn * xn + yn * yn) <= 2.25 * r2_corner)
        uv = distort_points(intr, torch.stack([u, v], dim=-1))
        u, v = uv[..., 0], uv[..., 1]
    ui = _rounded_index(u, W)
    vi = _rounded_index(v, H)
    inside = inside & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)

    flat = vi.clamp(0, H - 1) * W + ui.clamp(0, W - 1)
    d = depth_m.reshape(-1)[flat]                             # ONE gather
    # sensors export NaN for invalid depth: clean it before the
    # arithmetic, or NaN * 0 reaches the accumulated voxels
    d = torch.nan_to_num(d, nan=0.0)
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
    return TSDFState(tsdf=t.reshape(shape), weight=w.reshape(shape))


@functools.lru_cache(maxsize=8)
def make_integrate(cfg: DenseMapConfig, intr: Intrinsics,
                   depth_scale: float = 1.0):
    """``fuse(state, depth_raw, pose_q, pose_t) -> state``; ``depth_scale``
    converts the raw image to metres (1.0 for metric input,
    ``MapConfig.depth_scale`` for integer sensor depth)."""
    def fuse(s, d, q, t):
        return integrate(s, d.to(torch.float32) * depth_scale, SE3(q, t),
                         intr, cfg)
    return fuse


def shard_tsdf(state: TSDFState, group: ShardGroup) -> TSDFState:
    """This rank's slab of the volume: x rows [r nx/W, (r + 1) nx/W), as
    copies. Raises ``ValueError`` when nx is not divisible by the world
    size W."""
    return block_tree(state, group)


def gather_tsdf(state: TSDFState, group: ShardGroup) -> TSDFState:
    """The whole volume on every rank, the slabs stacked in rank order."""
    return gather_tree(state, group)


def make_sharded_integrate(cfg: DenseMapConfig, intr: Intrinsics,
                           group: ShardGroup, depth_scale: float = 1.0):
    """``fuse(slab, depth_raw, pose_q, pose_t) -> slab``, as
    ``make_integrate`` on this rank's slab of the volume (``shard_tsdf``),
    with the depth image and pose every rank's. Makes no collective.
    Raises ``ValueError`` when nx is not divisible by the world size."""
    x0, _ = group.rows(cfg.dims[0], "the volume's x voxels")

    def fuse(s, d, q, t):
        return integrate(s, d.to(torch.float32) * depth_scale, SE3(q, t),
                         intr, cfg, x0)
    return fuse


def integrate_sequence(depths_m, poses, intr: Intrinsics, cfg: DenseMapConfig,
                       state: TSDFState | None = None,
                       device=None) -> TSDFState:
    """Offline: fuse a whole sequence, [T, H, W] metric depth and poses as
    [T, 4, 4] matrices or one batched SE3 (q [T, 4], t [T, 3]), into
    ``state`` (default: an empty volume on ``device``). Use after loop
    closure with the corrected poses."""
    if state is None:
        state = empty_tsdf(cfg, device)
    dev = state.tsdf.device
    if isinstance(poses, SE3):
        qs = np.asarray(poses.q.cpu(), np.float32)
        ts = np.asarray(poses.t.cpu(), np.float32)
    else:
        poses = np.asarray(poses, np.float32)
        if poses.ndim != 3 or poses.shape[1:] != (4, 4):
            raise ValueError("poses must be [T,4,4] matrices or a "
                             "batched SE3")
        qs = np.stack([_rot_to_quat(p[:3, :3]) for p in poses])
        ts = poses[:, :3, 3]
    depths = torch.as_tensor(np.asarray(depths_m, np.float32)).to(dev)
    qs = torch.from_numpy(np.asarray(qs, np.float32)).to(dev)
    ts = torch.from_numpy(np.ascontiguousarray(ts, np.float32)).to(dev)
    for i in range(depths.shape[0]):
        state = integrate(state, depths[i], SE3(qs[i], ts[i]), intr, cfg)
    return state


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """[3,3] -> wxyz (host-side, eval/offline only)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def surface_points(state: TSDFState, cfg: DenseMapConfig,
                   min_weight: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the zero-crossing point cloud (host-side; not hot).

    Voxels with |tsdf| < iso_band and enough weight are surface
    candidates; each is refined along the central-difference TSDF
    gradient to the zero crossing: X_s = X - tsdf*tau*grad/|grad|.
    Returns (points [M,3] world, per-point |tsdf| residual [M]). The
    volume may hold tensors on any device or numpy arrays."""
    t, w = (torch.as_tensor(a).cpu().numpy() for a in state)
    band = (np.abs(t) < cfg.iso_band) & (w >= min_weight)
    # gradient only valid where the neighborhood is observed
    w_ok = w >= min_weight
    interior = np.zeros_like(band)
    interior[1:-1, 1:-1, 1:-1] = (
        band[1:-1, 1:-1, 1:-1]
        & w_ok[2:, 1:-1, 1:-1] & w_ok[:-2, 1:-1, 1:-1]
        & w_ok[1:-1, 2:, 1:-1] & w_ok[1:-1, :-2, 1:-1]
        & w_ok[1:-1, 1:-1, 2:] & w_ok[1:-1, 1:-1, :-2])
    idx = np.argwhere(interior)
    if idx.size == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0,), np.float32)
    ix, iy, iz = idx[:, 0], idx[:, 1], idx[:, 2]
    g = np.stack([
        t[ix + 1, iy, iz] - t[ix - 1, iy, iz],
        t[ix, iy + 1, iz] - t[ix, iy - 1, iz],
        t[ix, iy, iz + 1] - t[ix, iy, iz - 1],
    ], axis=1) / (2.0 * cfg.voxel_size)          # d tsdf / d metre
    gn = np.linalg.norm(g, axis=1, keepdims=True)
    g = g / np.maximum(gn, 1e-9)
    X = np.asarray(cfg.origin, np.float32) \
        + (idx.astype(np.float32) + 0.5) * cfg.voxel_size
    tv = t[ix, iy, iz]
    pts = X - (tv * cfg.truncation)[:, None] * g
    return pts.astype(np.float32), np.abs(tv).astype(np.float32)
