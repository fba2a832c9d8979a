"""Frame-to-model alignment of a depth image to K submaps, as plain eager
torch, frozen from the port (``kbslam_torch/mapping/icp.py``:
``align_depth_to_atlas`` and the shell's acceptance of a result) for the
benchmark's reference.

Every ``stride``-th pixel is back-projected; Gauss-Newton minimises the
Huber-weighted squared trilinear TSDF (in metres) at the points moved by
a left-multiplied se(3) step, over ``iters`` fixed trips and one final
fetch. Per trip each point is moved into every slot's anchor frame and
the newest slot whose whole 2x2x2 neighbourhood is observed wins (first
valid wins): the slots' normal equations are not summed.

Departure from the program: the slots come as a list of volumes (the
check's copies), packed with the sentinel one by one and stacked,
where the program selects them from its ring with ``index_select``; the
values are the same.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from slambench.reference.geom.camera import Intrinsics, undistort_points
from slambench.reference.geom.se3 import SE3, quat_rotate, quat_to_matrix

_SENTINEL = 4.0  # packed "unobserved" value; a real TSDF lies in [-1, 1]


class IcpResult(NamedTuple):
    q: torch.Tensor          # [4] refined camera-to-world rotation (wxyz)
    t: torch.Tensor          # [3]
    num_valid: torch.Tensor  # i32 points alive in the first and last fetch
    rmse_init: torch.Tensor  # f32 metres, robust SDF RMSE before the solve
    rmse: torch.Tensor       # f32 metres, and after it


def _trilinear_sdf(packed, cfg, X):
    """Trilinear TSDF at X [K, P, 3] of the [K, V] packed slots, slot k's
    points reading slot k: (phi [K, P], grad [K, P, 3] per metre, valid
    [K, P])."""
    nx, ny, nz = cfg.dims
    h = cfg.voxel_size
    valid = torch.ones(X.shape[:-1], dtype=torch.bool, device=X.device)
    idx, f = [], []
    for a, n in enumerate(cfg.dims):
        g = (X[..., a] - cfg.origin[a]) / h - 0.5
        i0 = torch.floor(g)
        f.append(g - i0)
        valid = valid & (i0 >= 0) & (i0 <= n - 2)
        idx.append(i0.clamp(0, n - 2).to(torch.int64))
    base = (idx[0] * ny + idx[1]) * nz + idx[2]
    V = packed.shape[1]
    base = base + (torch.arange(packed.shape[0], device=X.device) * V)[:, None]
    k = torch.arange(8, device=X.device)
    off = ((k >> 2) * ny + ((k >> 1) & 1)) * nz + (k & 1)
    c = packed.reshape(-1)[base[..., None] + off]
    valid = valid & (c < 2.0).all(dim=-1)
    wx, wy, wz = ((1 - a, a) for a in f)
    w = torch.stack([wx[dx] * wy[dy] * wz[dz] for dx in (0, 1)
                     for dy in (0, 1) for dz in (0, 1)], dim=-1)
    phi = (c * w).sum(dim=-1)

    def pairs(u, v):
        return torch.stack([u[i] * v[j] for i in (0, 1) for j in (0, 1)], -1)

    c3 = c.reshape(c.shape[:-1] + (2, 2, 2))
    flat = c.shape[:-1] + (4,)
    gx = ((c3[..., 1, :, :] - c3[..., 0, :, :]).reshape(flat)
          * pairs(wy, wz)).sum(dim=-1)
    gy = ((c3[..., :, 1, :] - c3[..., :, 0, :]).reshape(flat)
          * pairs(wx, wz)).sum(dim=-1)
    gz = ((c3[..., :, :, 1] - c3[..., :, :, 0]).reshape(flat)
          * pairs(wx, wy)).sum(dim=-1)
    return phi, torch.stack([gx, gy, gz], dim=-1) / h, valid


def _frame_points(depth_m, intr: Intrinsics, cfg, stride: int):
    d = depth_m[::stride, ::stride]
    h, w = d.shape
    dev = depth_m.device
    u = (torch.arange(w, dtype=torch.float32, device=dev) * stride).expand(h, w)
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


def align_depth_to_atlas(volumes, anchor_q, anchor_t, depth_m, q0, t0,
                         intr: Intrinsics, cfg, icp) -> IcpResult:
    """Align one metric depth image [H, W] from camera-to-world (q0, t0)
    to K submaps: ``volumes`` the K slots' (tsdf, weight) newest first,
    ``anchor_q`` [K, 4] and ``anchor_t`` [K, 3] their anchors' current
    poses."""
    packed = torch.stack([torch.where(v.weight > 0, v.tsdf,
                                      _SENTINEL).reshape(-1)
                          for v in volumes])                    # [K, V]
    R = quat_to_matrix(anchor_q)
    p_cam, p_ok = _frame_points(depth_m, intr, cfg, icp.stride)
    ks = torch.arange(len(volumes), device=p_cam.device)[:, None]

    def fetch(q, t):
        X = quat_rotate(q, p_cam) + t
        Xl = torch.matmul(X[None] - anchor_t[:, None], R)
        phis, g, valids = _trilinear_sdf(packed, cfg, Xl)
        gws = torch.matmul(g, R.transpose(1, 2))
        first = torch.argmax(valids.to(torch.uint8), dim=0)
        sel = (ks == first[None]) & valids
        phi = torch.where(sel, phis, 0.0).sum(dim=0)
        grad = torch.where(sel[..., None], gws, 0.0).sum(dim=0)
        valid = valids.any(dim=0) & p_ok & (phi.abs() < 0.999)
        r = phi * cfg.truncation
        g = grad * cfg.truncation
        w = torch.clamp_max(icp.huber_m / torch.clamp_min(r.abs(), 1e-12), 1.0)
        wv = torch.where(valid, w, 0.0)
        n = valid.sum().to(torch.int32)
        rmse = torch.sqrt((wv * r * r).sum() / torch.clamp_min(wv.sum(), 1e-12))
        return X, r, g, wv, n, rmse

    q, t = q0, t0
    eye = torch.eye(6, dtype=torch.float32, device=p_cam.device)
    n0 = torch.zeros((), dtype=torch.int32, device=p_cam.device)
    rmse0 = torch.zeros((), dtype=torch.float32, device=p_cam.device)
    for k in range(icp.iters):
        X, r, g, wv, n, rmse = fetch(q, t)
        if k == 0:
            n0, rmse0 = n, rmse
        J = torch.cat([g, torch.linalg.cross(X, g, dim=-1)], dim=1)
        Jw = J * wv[:, None]
        H = Jw.T @ J
        b = -(Jw * r[:, None]).sum(dim=0)
        Hd = H + (icp.damping * torch.trace(H) / 6.0 + 1e-9) * eye
        xi = torch.linalg.solve_ex(Hd, b[:, None]).result[:, 0]
        xi = torch.where(torch.isfinite(xi).all() & (n > 0), xi, 0.0)
        T = (SE3.exp(xi) @ SE3(q, t)).normalize()
        q, t = T.q, T.t
    _, _, _, _, n1, rmse1 = fetch(q, t)
    return IcpResult(q, t, torch.minimum(n0, n1), rmse0, rmse1)


def accepted(res: IcpResult, icp, refine: bool) -> bool:
    """The shell's gates on a result: enough live points, a final RMSE
    under the ceiling and no worse than the first (in refine, strictly
    better)."""
    # float32 against the gates, as the shell reads them
    n = int(res.num_valid)
    r0, r1 = res.rmse_init.cpu().numpy(), res.rmse.cpu().numpy()
    ok = n >= icp.min_points and r1 <= icp.accept_rmse_m and r1 <= r0
    return bool(ok and (r1 < r0 if refine else True))
