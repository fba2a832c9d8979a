"""TSDF raycasting: render depth and normal images from the dense volume.

Port of kbslam/mapping/raycast.py. Given the fused TSDF (the monolithic
volume, or one submap of the atlas) and a camera pose, ``raycast``
predicts the depth image the map expects from that view;
``render_consistency`` compares it with an observed depth image, a
map-quality metric.

Every ray takes the same fixed steps of 0.75 x truncation (the TSDF is
clamped to +-1 outside the band, so a surface crossing cannot be
stepped over): one gather of shape [S, H*W] fetches every sample, the
first + to - transition per ray comes from one ``argmax`` over the step
axis (``torch.argmax`` returns the first maximum, as ``jnp.argmax``
does; it refuses ``bool``, so the crossings are ``uint8``), the hit is
refined by linear interpolation of the two bracketing samples, and the
normal is the central-difference TSDF gradient at the hit point.
Out-of-volume and never-observed samples read +1 (free space), so rays
that miss report depth 0 and a zero normal.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from kbslam_torch.config import DenseMapConfig
from kbslam_torch.geom.camera import Intrinsics, distort_points
from kbslam_torch.geom.se3 import SE3, quat_rotate
from kbslam_torch.mapping.dense import TSDFState


class RaycastResult(NamedTuple):
    depth: torch.Tensor    # [H, W] f32 metres, 0 where the ray missed
    normal: torch.Tensor   # [H, W, 3] f32 unit world normals, 0 on miss
    hit: torch.Tensor      # [H, W] bool


def _sample(tsdf_flat, weight_flat, cfg: DenseMapConfig, X):
    """Nearest-neighbour TSDF at world points X [..., 3]; unobserved or
    out-of-volume reads +1 (free space). Also returns the in-volume
    mask."""
    nx, ny, nz = cfg.dims
    inside = torch.ones(X.shape[:-1], dtype=torch.bool, device=X.device)
    idx = []
    for a, n in enumerate(cfg.dims):
        gi = torch.round((X[..., a] - cfg.origin[a]) / cfg.voxel_size - 0.5)
        inside = inside & (gi >= 0) & (gi < n)
        idx.append(gi.clamp(0, n - 1).to(torch.int64))
    flat = (idx[0] * ny + idx[1]) * nz + idx[2]
    t = tsdf_flat[flat]
    observed = weight_flat[flat] > 0
    return torch.where(inside & observed, t, 1.0), inside


def raycast(state: TSDFState, pose: SE3, intr: Intrinsics,
            height: int, width: int, cfg: DenseMapConfig,
            t_min: float = 0.05, t_max: float = 12.0) -> RaycastResult:
    """Render the volume from camera-to-world ``pose`` (pinhole: the
    prediction lives in undistorted pixel space)."""
    dev = state.tsdf.device
    tsdf_flat = state.tsdf.reshape(-1)
    weight_flat = state.weight.reshape(-1)

    # pixel rays in the camera frame (unit z), rotated to the world
    u = torch.arange(width, dtype=torch.float32, device=dev).expand(height,
                                                                   width)
    v = torch.arange(height, dtype=torch.float32,
                     device=dev)[:, None].expand(height, width)
    d_cam = torch.stack([(u - intr.cx) / intr.fx, (v - intr.cy) / intr.fy,
                         torch.ones_like(u)], dim=-1).reshape(-1, 3)
    d_world = quat_rotate(pose.q, d_cam)                # [R, 3]
    o = pose.t                                          # [3]

    step = 0.75 * cfg.truncation
    n_steps = int(-(-(t_max - t_min) // step)) + 1      # the reference's
    ts = t_min + step * torch.arange(n_steps, dtype=torch.float32,
                                     device=dev)        # [S]

    X = o + ts[:, None, None] * d_world[None]           # [S, R, 3]
    s, _ = _sample(tsdf_flat, weight_flat, cfg, X)      # [S, R]

    # first + to - transition along each ray
    cross = (s[:-1] > 0) & (s[1:] <= 0)                 # [S-1, R]
    hit = cross.any(dim=0)
    k = torch.argmax(cross.to(torch.uint8), dim=0)      # [R]
    s0 = torch.gather(s, 0, k[None])[0]
    s1 = torch.gather(s, 0, (k + 1)[None])[0]
    frac = s0 / torch.clamp_min(s0 - s1, 1e-12)
    t_hit = ts[k] + frac * step                         # [R]

    Xh = o + t_hit[:, None] * d_world                   # [R, 3]

    # central-difference gradient at the hit point -> world normal
    eye = cfg.voxel_size * torch.eye(3, dtype=torch.float32, device=dev)
    sp, _ = _sample(tsdf_flat, weight_flat, cfg, Xh[None] + eye[:, None])
    sm, _ = _sample(tsdf_flat, weight_flat, cfg, Xh[None] - eye[:, None])
    g = (sp - sm).T                                     # [R, 3]
    gn = torch.linalg.norm(g, dim=1, keepdim=True)
    normal = torch.where(gn > 1e-9, g / torch.clamp_min(gn, 1e-9), 0.0)

    # depth is the z-component in the camera frame (as sensor depth
    # images are), not the ray parameter
    z = t_hit * d_cam[:, 2]
    depth = torch.where(hit, z, 0.0).reshape(height, width)
    normal = torch.where(hit[:, None], normal, 0.0).reshape(height, width, 3)
    return RaycastResult(depth=depth, normal=normal,
                         hit=hit.reshape(height, width))


@functools.lru_cache(maxsize=8)
def make_raycast(cfg: DenseMapConfig, intr: Intrinsics, height: int,
                 width: int, t_min: float = 0.05, t_max: float = 12.0):
    """``run(state, q, t) -> RaycastResult`` with a wxyz quaternion and a
    translation (camera-to-world) on the volume's device."""
    def run(state, q, t):
        return raycast(state, SE3(q, t), intr, height, width, cfg,
                       t_min=t_min, t_max=t_max)
    return run


def resolve_render_model(tsdf, atlas, map_state, q, t):
    """The volume and the model-frame pose to render camera-to-world
    (q, t) from, host-side: (TSDFState, SE3, None) for the monolithic
    volume; for the submap atlas its active submap, re-posed by its
    anchor's current ring pose (``submap.recent_slots_with_poses``), with
    the pose in that submap's frame and the anchor SE3 (a one-submap
    view: the newest chunk is where the camera looks); (None, None, None)
    when no fused model exists."""
    if tsdf is not None:
        dev = tsdf.tsdf.device
    elif atlas is not None and atlas.count > 0:
        dev = atlas.tsdf.device
    else:
        return None, None, None
    pose = SE3(torch.as_tensor(q, dtype=torch.float32, device=dev),
               torch.as_tensor(t, dtype=torch.float32, device=dev))
    if tsdf is not None:
        return tsdf, pose, None
    from kbslam_torch.mapping.submap import recent_slots_with_poses

    slots, aq, at = recent_slots_with_poses(atlas, map_state, 1)
    s = int(slots[0])
    anchor = SE3(torch.from_numpy(aq[0]).to(dev),
                 torch.from_numpy(at[0]).to(dev))
    return (TSDFState(atlas.tsdf[s], atlas.weight[s]),
            (anchor.inverse() @ pose).normalize(), anchor)


def render_consistency(state: TSDFState, pose: SE3, depth_obs,
                       intr: Intrinsics, cfg: DenseMapConfig,
                       t_max: float = 12.0) -> dict:
    """Rendered against observed depth at one pose (host-side, not hot).
    ``depth_obs`` is [H, W] metric depth in the sensor's (distorted,
    when the camera has a distortion model) pixel space. Returns the
    median and p90 absolute depth error over pixels where the render hit
    and the sensor returned valid depth, and that coverage fraction.

    The render lives in undistorted pixel space, so with a distorted
    camera the observation is read at the forward-distorted coordinates
    of each rendered pixel (depth == z does not change under the pixel
    warp; only the lookup moves), as ``dense.integrate`` reads it."""
    H, W = depth_obs.shape
    f = make_raycast(cfg, intr, H, W, t_max=t_max)
    r = f(state, pose.q, pose.t)
    dr = r.depth.cpu().numpy()
    ob = np.asarray(depth_obs)
    hit = r.hit.cpu().numpy()
    if intr.has_distortion:
        uu, vv = np.meshgrid(np.arange(W, dtype=np.float32),
                             np.arange(H, dtype=np.float32))
        uvd = distort_points(intr, torch.from_numpy(
            np.stack([uu, vv], axis=-1))).numpy()
        ui = np.round(uvd[..., 0]).astype(np.int64)
        vi = np.round(uvd[..., 1]).astype(np.int64)
        inb = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
        ob = np.where(inb, ob[np.clip(vi, 0, H - 1),
                              np.clip(ui, 0, W - 1)], 0.0)
        hit = hit & inb
    valid = hit & (ob > cfg.min_depth) & (ob < cfg.max_depth)
    if not valid.any():
        return {"median_err_m": float("nan"), "p90_err_m": float("nan"),
                "coverage": 0.0}
    err = np.abs(dr[valid] - ob[valid])
    return {"median_err_m": float(np.median(err)),
            "p90_err_m": float(np.percentile(err, 90)),
            "coverage": float(valid.mean())}
