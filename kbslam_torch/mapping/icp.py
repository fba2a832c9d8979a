"""Frame-to-model dense tracking: direct alignment of a depth image to the
TSDF.

Port of kbslam/mapping/icp.py. The reference tracks frame to keyframe
only (ORB, BFMatcher, solvePnPRansac) and loses the pose whenever
feature matching starves; this aligns the frame's depth directly against
the fused volume (``mapping/dense.py``) or the newest submaps of the
atlas (``mapping/submap.py``), a pose source that needs no texture.

Objective: r_i = tau * T_tsdf(T p_i), the trilinear TSDF (in metres) at
the transformed sample point, which is the signed distance to the
nearest surface inside the truncation band. Gauss-Newton minimizes
sum_i w_i r_i^2 over a left-multiplied se(3) step (J_i = [g_i, X_i x
g_i], g the metric TSDF gradient), Huber-weighted, over points whose
whole trilinear neighbourhood is observed and whose TSDF lies strictly
inside the clamp band. Per trip: one ``[P, 8]`` corner gather (per slot
with the atlas), the gradient from the same 8 corners, the 6x6 normal
equations in float32 (TF32 stays off, ``device.pick_device``) and one
damped solve by ``torch.linalg.solve_ex``, which, unlike ``solve``, does
not check for errors and so makes no host sync; the guard
``isfinite(xi).all() & (n > 0)`` holds the pose on a singular system.
The reference's fixed-trip ``fori_loop`` is a Python loop of ``iters``
trips with no data-dependent exit, so a solve makes no host read and
can be captured as one CUDA graph.

The shells accept or reject a result on the host from its stats; an
empty or never-observed model gives ``num_valid == 0`` and the pose
back unchanged.

``align_depth_to_atlas`` marks its stages (``utils.profiling.mark``):
``icp_pack`` (the [K, V] repack of its K slots with the sentinel) and
``icp_gn`` (the Gauss-Newton trips and the final fetch).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from kbslam_torch.config import DenseIcpConfig, DenseMapConfig
from kbslam_torch.geom.camera import Intrinsics, undistort_points
from kbslam_torch.geom.se3 import SE3, quat_rotate, quat_to_matrix
from kbslam_torch.mapping.dense import TSDFState
from kbslam_torch.utils import profiling


class IcpResult(NamedTuple):
    q: torch.Tensor          # [4] refined camera-to-world rotation (wxyz)
    t: torch.Tensor          # [3] refined translation
    num_valid: torch.Tensor  # i32 points alive in the first and last fetch
    rmse_init: torch.Tensor  # f32 metres, robust SDF RMSE before the solve
    rmse: torch.Tensor       # f32 metres, and after it


_SENTINEL = 4.0  # packed "unobserved" value; a real TSDF lies in [-1, 1]


def pack_volume(state: TSDFState) -> torch.Tensor:
    """The flat volume with unobserved voxels set to the sentinel, so one
    gather per corner tells value and observedness: a corner >= 2 makes
    the whole trilinear neighbourhood invalid."""
    return torch.where(state.weight > 0, state.tsdf, _SENTINEL).reshape(-1)


def _trilinear_sdf(packed, cfg: DenseMapConfig, X: torch.Tensor):
    """Trilinear TSDF at points X of a ``pack_volume`` array.

    ``packed`` [V] with X [P, 3], or [K, V] with X [K, P, 3], where slot
    k's points read slot k. Returns (phi [...] tsdf units, grad [..., 3]
    tsdf units per metre, valid [...]). The gradient is the analytic
    derivative of the interpolant from the same 8 corner values; valid
    asks for the whole 2x2x2 neighbourhood inside the grid and
    observed."""
    nx, ny, nz = cfg.dims
    h = cfg.voxel_size
    valid = torch.ones(X.shape[:-1], dtype=torch.bool, device=X.device)
    idx, f = [], []
    for a, n in enumerate(cfg.dims):
        g = (X[..., a] - cfg.origin[a]) / h - 0.5
        i0 = torch.floor(g)
        f.append(g - i0)                                      # in [0, 1)
        valid = valid & (i0 >= 0) & (i0 <= n - 2)
        idx.append(i0.clamp(0, n - 2).to(torch.int64))
    base = (idx[0] * ny + idx[1]) * nz + idx[2]
    if packed.dim() == 2:                     # slot k's voxels at k * V
        V = packed.shape[1]
        base = base + (torch.arange(packed.shape[0], device=X.device)
                       * V)[:, None]
    # corner order: bit 2 -> +x, bit 1 -> +y, bit 0 -> +z
    k = torch.arange(8, device=X.device)
    off = ((k >> 2) * ny + ((k >> 1) & 1)) * nz + (k & 1)
    c = packed.reshape(-1)[base[..., None] + off]             # ONE gather
    valid = valid & (c < 2.0).all(dim=-1)

    # corner weights and the gradient's corner differences, built by
    # products and slices (an index list would be a host-to-device copy)
    wx, wy, wz = ((1 - a, a) for a in f)
    w = torch.stack([wx[dx] * wy[dy] * wz[dz] for dx in (0, 1)
                     for dy in (0, 1) for dz in (0, 1)], dim=-1)
    phi = (c * w).sum(dim=-1)

    # analytic gradient: corner differences along each axis, weighted by
    # the other two axes' factors
    def pairs(u, v):
        return torch.stack([u[i] * v[j] for i in (0, 1) for j in (0, 1)], -1)

    c3 = c.reshape(c.shape[:-1] + (2, 2, 2))       # [..., dx, dy, dz]
    flat = c.shape[:-1] + (4,)
    gx = ((c3[..., 1, :, :] - c3[..., 0, :, :]).reshape(flat)
          * pairs(wy, wz)).sum(dim=-1)
    gy = ((c3[..., :, 1, :] - c3[..., :, 0, :]).reshape(flat)
          * pairs(wx, wz)).sum(dim=-1)
    gz = ((c3[..., :, :, 1] - c3[..., :, :, 0]).reshape(flat)
          * pairs(wx, wy)).sum(dim=-1)
    grad = torch.stack([gx, gy, gz], dim=-1) / h
    return phi, grad, valid


def _frame_points(depth_m: torch.Tensor, intr: Intrinsics,
                  cfg: DenseMapConfig, stride: int):
    """Every stride-th pixel back-projected to camera-frame points [P, 3],
    with validity [P]. Depth pixels live in distorted space: rays are
    undistorted before unprojection when the camera has a model."""
    d = depth_m[::stride, ::stride]
    h, w = d.shape
    dev = depth_m.device
    u = (torch.arange(w, dtype=torch.float32, device=dev)
         * stride).expand(h, w)
    v = (torch.arange(h, dtype=torch.float32, device=dev)[:, None]
         * stride).expand(h, w)
    uv = torch.stack([u, v], dim=-1).reshape(-1, 2)
    d = torch.nan_to_num(d, nan=0.0).reshape(-1)
    ok = (d > cfg.min_depth) & (d < cfg.max_depth)
    if intr.has_distortion:
        uv = undistort_points(intr, uv)
    p = torch.stack([(uv[:, 0] - intr.cx) / intr.fx * d,
                     (uv[:, 1] - intr.cy) / intr.fy * d, d], dim=1)
    return p, ok


def _residuals(sdf_fn, cfg, icp, p_cam, p_ok, q, t):
    """One fetch at pose (q, t): (X [P, 3], r [P] metres, g [P, 3],
    wv [P] robust weights, 0 where invalid, n i32, rmse f32).
    ``sdf_fn(X_world) -> (phi, grad_world, valid)`` is the model."""
    X = quat_rotate(q, p_cam) + t
    phi, grad, valid = sdf_fn(X)
    # clamped cells (|tsdf| ~ 1) have zero gradient: drop them, so they
    # cannot bias the Huber scale either
    valid = valid & p_ok & (phi.abs() < 0.999)
    r = phi * cfg.truncation
    g = grad * cfg.truncation
    w = torch.clamp_max(icp.huber_m / torch.clamp_min(r.abs(), 1e-12), 1.0)
    wv = torch.where(valid, w, 0.0)
    n = valid.sum().to(torch.int32)
    rmse = torch.sqrt((wv * r * r).sum() / torch.clamp_min(wv.sum(), 1e-12))
    return X, r, g, wv, n, rmse


def _gn_align(sdf_fn, p_cam, p_ok, q0, t0, cfg: DenseMapConfig,
              icp: DenseIcpConfig) -> IcpResult:
    """Gauss-Newton alignment of back-projected points to an SDF model
    from camera-to-world (q0, t0): ``icp.iters`` trips of one fetch and
    one damped 6x6 solve; trip 0's fetch gives the initial stats and one
    more fetch evaluates the final pose."""
    q, t = q0, t0
    eye = torch.eye(6, dtype=torch.float32, device=p_cam.device)
    for k in range(icp.iters):
        X, r, g, wv, n, rmse = _residuals(sdf_fn, cfg, icp, p_cam, p_ok,
                                          q, t)
        if k == 0:
            n0, rmse0 = n, rmse
        J = torch.cat([g, torch.linalg.cross(X, g, dim=-1)], dim=1)
        Jw = J * wv[:, None]
        H = Jw.T @ J
        b = -(Jw * r[:, None]).sum(dim=0)
        # Levenberg diagonal damping holds the directions the visible
        # geometry leaves free (a single plane: 3 of them) at the prior
        Hd = H + (icp.damping * torch.trace(H) / 6.0 + 1e-9) * eye
        xi = torch.linalg.solve_ex(Hd, b[:, None]).result[:, 0]
        # no valid point -> singular system -> NaN step: hold the pose
        xi = torch.where(torch.isfinite(xi).all() & (n > 0), xi, 0.0)
        T = (SE3.exp(xi) @ SE3(q, t)).normalize()
        q, t = T.q, T.t
    if icp.iters == 0:
        n0 = torch.zeros((), dtype=torch.int32, device=p_cam.device)
        rmse0 = torch.zeros((), dtype=torch.float32, device=p_cam.device)
    _, _, _, _, n1, rmse1 = _residuals(sdf_fn, cfg, icp, p_cam, p_ok, q, t)
    return IcpResult(q=q, t=t, num_valid=torch.minimum(n0, n1),
                     rmse_init=rmse0, rmse=rmse1)


def align_depth_to_tsdf(state: TSDFState, depth_m, q0, t0, intr: Intrinsics,
                        cfg: DenseMapConfig, icp: DenseIcpConfig) -> IcpResult:
    """Align one metric depth image to the monolithic volume."""
    packed = pack_volume(state)
    p_cam, p_ok = _frame_points(depth_m, intr, cfg, icp.stride)
    return _gn_align(functools.partial(_trilinear_sdf, packed, cfg), p_cam,
                     p_ok, q0, t0, cfg, icp)


def align_depth_to_atlas(atlas, slots, anchor_q, anchor_t, depth_m, q0, t0,
                         intr: Intrinsics, cfg: DenseMapConfig,
                         icp: DenseIcpConfig) -> IcpResult:
    """Align one metric depth image to K submaps of a ``SubmapAtlas``,
    each re-posed by its anchor keyframe's current ring pose, so recovery
    follows BA and loop corrections.

      slots     [K] int: ring slots, newest first (a duplicate is
                harmless: each point takes the first valid slot, and a
                duplicate carries the same values);
      anchor_q  [K, 4], anchor_t [K, 3]: each slot's anchor pose now.

    Per trip: one [P, 8] corner gather per slot, the points moved into
    each slot's anchor frame, then per point the newest valid slot wins:
    overlapping submaps are slightly inconsistent rigid bodies, so their
    normal equations are not summed. Local gradients reach the world
    through the anchor rotation (X_l = R^T (X_w - t), so grad_w =
    R grad_l)."""
    profiling.mark(None, depth_m)
    slots = slots.to(torch.int64)
    packed = torch.where(atlas.weight.index_select(0, slots) > 0,
                         atlas.tsdf.index_select(0, slots),
                         _SENTINEL).reshape(slots.shape[0], -1)  # [K, V]
    profiling.mark("icp_pack", depth_m)
    R = quat_to_matrix(anchor_q)                                 # [K, 3, 3]
    p_cam, p_ok = _frame_points(depth_m, intr, cfg, icp.stride)
    K = slots.shape[0]
    ks = torch.arange(K, device=p_cam.device)[:, None]

    def sdf_fn(X):                                               # [P, 3]
        Xl = torch.matmul(X[None] - anchor_t[:, None], R)        # [K, P, 3]
        phis, g, valids = _trilinear_sdf(packed, cfg, Xl)
        gws = torch.matmul(g, R.transpose(1, 2))                 # to world
        first = torch.argmax(valids.to(torch.uint8), dim=0)      # [P]
        sel = (ks == first[None]) & valids
        phi = torch.where(sel, phis, 0.0).sum(dim=0)
        gw = torch.where(sel[..., None], gws, 0.0).sum(dim=0)
        return phi, gw, valids.any(dim=0)

    res = _gn_align(sdf_fn, p_cam, p_ok, q0, t0, cfg, icp)
    profiling.mark("icp_gn", depth_m)
    return res


@functools.lru_cache(maxsize=8)
def make_icp(cfg: DenseMapConfig, icp: DenseIcpConfig, intr: Intrinsics,
             depth_scale: float = 1.0):
    """``run(state, depth_raw, q, t) -> IcpResult``; ``depth_scale`` turns
    the raw image into metres (1.0 for metric input,
    ``MapConfig.depth_scale`` for integer sensor depth)."""
    def run(state, depth_raw, q, t):
        return align_depth_to_tsdf(state, depth_raw.to(torch.float32)
                                   * depth_scale, q, t, intr, cfg, icp)
    return run


@functools.lru_cache(maxsize=8)
def make_icp_atlas(cfg: DenseMapConfig, icp: DenseIcpConfig,
                   intr: Intrinsics, depth_scale: float = 1.0):
    """``run(atlas, slots [K], anchor_q [K, 4], anchor_t [K, 3],
    depth_raw, q, t) -> IcpResult``, slots newest first and each anchor
    pose its current ring pose (``submap.recent_slots_with_poses`` builds
    the triple)."""
    def run(atlas, slots, aq, at, depth_raw, q, t):
        return align_depth_to_atlas(atlas, slots, aq, at,
                                    depth_raw.to(torch.float32)
                                    * depth_scale, q, t, intr, cfg, icp)
    return run
