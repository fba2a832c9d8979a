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
inside the clamp band: per trip one fetch of the 8 corners of every
point (per slot with the atlas, the newest valid slot winning), the 6x6
normal equations in float32 (TF32 stays off, ``device.pick_device``) and
one damped solve; the guard ``isfinite(xi).all() & (n > 0)`` holds the
pose on a singular system. The reference's fixed-trip ``fori_loop`` is a
loop of ``iters`` trips with no data-dependent exit, so a solve makes no
host read and can be captured as one CUDA graph.

The solve itself is ``ops/icp.py``: each fetch on the card one launch
of a hand-written kernel (``csrc/icp.cu``) that reads the slots in place
and gives the plain twin's bits, the CPU the twin. This module
back-projects the depth image (``_frame_points``, once per solve) and
hands over the slots: the atlas's ring with the window's slot ids and
anchor poses, or the monolithic volume as a ring of one read in world
coordinates.

The shells accept or reject a result on the host from its stats; an
empty or never-observed model gives ``num_valid == 0`` and the pose
back unchanged.

``align_depth_to_atlas`` marks its stages (``utils.profiling.mark``):
``icp_pack`` (empty since the kernel reads the slots in place: it held
the [K, V] repack of the K slots) and ``icp_gn`` (the back-projection,
the Gauss-Newton trips and the final fetch).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from kbslam_torch.config import DenseIcpConfig, DenseMapConfig
from kbslam_torch.geom.camera import Intrinsics, undistort_points
from kbslam_torch.mapping.dense import TSDFState
from kbslam_torch.ops import icp as icp_ops
from kbslam_torch.utils import profiling


class IcpResult(NamedTuple):
    q: torch.Tensor          # [4] refined camera-to-world rotation (wxyz)
    t: torch.Tensor          # [3] refined translation
    num_valid: torch.Tensor  # i32 points alive in the first and last fetch
    rmse_init: torch.Tensor  # f32 metres, robust SDF RMSE before the solve
    rmse: torch.Tensor       # f32 metres, and after it


def pack_volume(state: TSDFState) -> torch.Tensor:
    """The JAX package's packed volume: flat, unobserved voxels set to the
    sentinel, so one gather per corner tells value and observedness (a
    corner >= 2 makes the whole trilinear neighbourhood invalid). Off the
    solve's path, which reads ``weight > 0`` in place; the tests hold
    that fetch to this one."""
    return torch.where(state.weight > 0, state.tsdf,
                       icp_ops.SENTINEL).reshape(-1)


def _trilinear_sdf(packed, cfg: DenseMapConfig, X: torch.Tensor):
    """Trilinear TSDF at points X of a ``pack_volume`` array.

    ``packed`` [V] with X [P, 3], or [K, V] with X [K, P, 3], where slot
    k's points read slot k. Returns (phi [...] tsdf units, grad [..., 3]
    tsdf units per metre, valid [...]). The gradient is the analytic
    derivative of the interpolant from the same 8 corner values; valid
    asks for the whole 2x2x2 neighbourhood inside the grid and
    observed."""
    base = 0
    if packed.dim() == 2:                     # slot k's voxels at k * V
        base = (torch.arange(packed.shape[0], device=X.device)
                * packed.shape[1])[:, None]
    idx, f, inside = icp_ops.corners(cfg, X, base)
    c = packed.reshape(-1)[idx]                               # ONE gather
    phi, grad = icp_ops.interpolate(c, f, cfg.voxel_size)
    return phi, grad, inside & (c < 2.0).all(dim=-1)


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


def align_depth_to_tsdf(state: TSDFState, depth_m, q0, t0, intr: Intrinsics,
                        cfg: DenseMapConfig, icp: DenseIcpConfig) -> IcpResult:
    """Align one metric depth image to the monolithic volume: a ring of
    one slot, read in world coordinates."""
    p_cam, p_ok = _frame_points(depth_m, intr, cfg, icp.stride)
    slot0 = torch.zeros(1, dtype=torch.int32, device=p_cam.device)
    return IcpResult(*icp_ops.align(state.tsdf[None], state.weight[None],
                                    slot0, None, None, p_cam, p_ok, q0, t0,
                                    cfg, icp))


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

    Per trip each point is moved into each slot's anchor frame (X_l =
    R^T (X_w - t)) until the first slot whose neighbourhood is valid,
    newest first: overlapping submaps are slightly inconsistent rigid
    bodies, so their normal equations are not summed. Local gradients
    reach the world through the anchor rotation (grad_w = R grad_l)."""
    profiling.mark(None, depth_m)
    profiling.mark("icp_pack", depth_m)
    p_cam, p_ok = _frame_points(depth_m, intr, cfg, icp.stride)
    res = IcpResult(*icp_ops.align(atlas.tsdf, atlas.weight,
                                   slots.to(torch.int32), anchor_q, anchor_t,
                                   p_cam, p_ok, q0, t0, cfg, icp))
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
