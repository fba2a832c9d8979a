"""Window problem of the sliding-window bundle adjustment.

Port of kbslam/ba/problem.py: the last W keyframes' poses, their
per-slot landmark ids, the construction-time behind-camera and chi^2
gates (fixed for the whole solve), the depth loss scales
w = 1/(alpha + beta z^2), the RGB-D depth-residual weights, the
observation and inlier counts that drive the pruning after the solve,
and the depth-prior anchor (first gated-in observation of the oldest
window keyframe). Every selection is a gather by device index, so
building the problem never reads the device from the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from slambench.reference.geom.camera import Intrinsics, project
from slambench.reference.geom.se3 import SE3
from slambench.reference.mapping.state import MapState, window_slots


class BAProblem(NamedTuple):
    slots: torch.Tensor       # [W] int32 ring slots, oldest first
    real: torch.Tensor        # [W] bool
    cam_q: torch.Tensor       # [W, 4] initial T_wc
    cam_t: torch.Tensor       # [W, 3]
    obs_uv: torch.Tensor      # [W, F, 2]
    mp_id: torch.Tensor       # [W, F] int32 landmark slot (-1 none)
    active: torch.Tensor      # [W, F] bool: the observation is in the solve
    w_z: torch.Tensor         # [W, F] depth loss scale (construction time)
    z_meas: torch.Tensor      # [W, F] measured keypoint depth (m; 0 = none)
    w_d: torch.Tensor         # [W, F] depth-residual weight 1/sigma^2 (0 = off)
    total_obs: torch.Tensor   # [P] int32 window observations per landmark
    inlier_obs: torch.Tensor  # [P] int32 gated-in observations per landmark
    touched: torch.Tensor     # [P] bool: the landmark appears in the window
    anchor_mp: torch.Tensor   # [] int32 landmark slot of the anchor (-1 none)
    anchor_cam: torch.Tensor  # [] int64 window index of the oldest real KF
    anchor_z0: torch.Tensor   # [] float32
    fixed_cam: int            # window index held constant (the newest)


def count_by_id(ids: torch.Tensor, size: int) -> torch.Tensor:
    """[size] int32 counts of ``ids``; ids equal to ``size`` go to a spare
    row and are dropped. Integer sums are exact in any order."""
    flat = ids.reshape(-1).to(torch.int64)
    out = torch.zeros(size + 1, dtype=torch.int32, device=ids.device)
    out.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return out[:size]


def build_problem(state: MapState, intr: Intrinsics, cfg) -> BAProblem:
    W = cfg.window
    P = state.capacity_mp
    F = state.kf_mp.shape[1]
    slots, _ids, real = window_slots(state, W)
    s64 = slots.to(torch.int64)

    cam_q = state.kf_q.index_select(0, s64)
    cam_t = state.kf_t.index_select(0, s64)
    obs_uv = state.kf_kp_xy.index_select(0, s64)
    mp_raw = state.kf_mp.index_select(0, s64)
    kp_valid = state.kf_kp_valid.index_select(0, s64)

    # kf_mp holds monotone ids (slot = id % P): references whose slot was
    # reallocated after a landmark-ring wrap are left out, and mp_id is
    # the storage slot from here on
    has_mp = state.mp_ref_live(mp_raw) & kp_valid & real[:, None]
    mp_id = torch.where(has_mp, torch.remainder(mp_raw, P), -1)

    # construction-time projection with the initial poses
    X = state.mp_pos.index_select(
        0, torch.clamp(mp_id, min=0).reshape(-1).to(torch.int64)
    ).reshape(W, F, 3)
    T = SE3(cam_q[:, None, :], cam_t[:, None, :])
    pc = T.inverse().apply(X)
    z = pc[..., 2]
    uv_proj, _ = project(intr, pc)
    err2 = torch.sum((uv_proj - obs_uv) ** 2, dim=-1)
    gate2 = cfg.chi2_gate * cfg.pixel_sigma * cfg.pixel_sigma

    active = has_mp & (z > 0.0) & (err2 <= gate2)
    w_z = 1.0 / (cfg.loss_alpha + cfg.loss_beta * z * z)

    # RGB-D depth residuals (the reference's objective when off)
    z_meas = state.kf_kp_depth.index_select(0, s64)
    if cfg.depth_residuals:
        sigma = torch.clamp(cfg.depth_res_sigma0 * z_meas * z_meas,
                            min=cfg.depth_res_sigma_min)
        whitened0 = torch.abs(z - z_meas) / sigma
        d_ok = active & (z_meas > 0.0) & (whitened0 <= cfg.depth_res_gate)
        w_d = torch.where(d_ok, 1.0 / (sigma * sigma), 0.0)
    else:
        w_d = torch.zeros_like(z_meas)

    # pruning counts: total counts every window observation of the
    # landmark, inliers only those that pass both gates
    total_obs = count_by_id(torch.where(has_mp, mp_id, P), P)
    inlier_obs = count_by_id(torch.where(active, mp_id, P), P)

    # depth-prior anchor: first gated-in slot of the oldest real keyframe
    # (argmax returns the first maximum, as jnp.argmax does)
    first_real = torch.argmax(real.to(torch.int32))
    oldest_active = active.index_select(0, first_real.reshape(1))[0]   # [F]
    j = torch.argmax(oldest_active.to(torch.int32))
    flat = (first_real * F + j).reshape(1)
    has_anchor = torch.any(oldest_active)
    anchor_mp = torch.where(has_anchor, mp_id.reshape(-1).index_select(
        0, flat)[0], -1).to(torch.int32)
    anchor_z0 = torch.where(has_anchor, z.reshape(-1).index_select(
        0, flat)[0], 0.0)

    return BAProblem(
        slots=slots, real=real, cam_q=cam_q, cam_t=cam_t, obs_uv=obs_uv,
        mp_id=mp_id.to(torch.int32), active=active, w_z=w_z, z_meas=z_meas,
        w_d=w_d, total_obs=total_obs, inlier_obs=inlier_obs,
        touched=total_obs > 0, anchor_mp=anchor_mp, anchor_cam=first_real,
        anchor_z0=anchor_z0, fixed_cam=W - 1)
