"""Dense ICP's Gauss-Newton solve: its fetch as a CUDA kernel, and the
plain twin.

``align`` aligns the points of one depth image to K TSDF slots that it
reads in place: ``tsdf`` and ``weight`` are ``[S, nx, ny, nz]`` (the
submap atlas's ring, or a monolithic volume as a ring of one), and
``slots`` [K] names the slots to read, newest first. With anchors
(``anchor_q`` [K, 4], ``anchor_t`` [K, 3]) slot k's points are moved
into its anchor's frame; without them the points are read in world
coordinates. A point takes the first slot whose whole 2x2x2
neighbourhood is inside the grid and observed (``weight > 0``). It
returns (q, t, num_valid, rmse_init, rmse) after ``icp.iters`` trips and
one more fetch (``mapping/icp.py`` has the objective); ``_gn_align``
runs the trips, the same torch code on either device.

- A CUDA tensor's fetches go to the hand-written kernel
  (kbslam_torch/csrc/icp.cu), one launch per fetch, iters + 1 a solve
  and no host read; or the call raises. The kernel gives the twin's
  fetch to the bit (the normal equations, the solve and the update stay
  the twin's torch), so a solve on the card equals the twin's on the
  card. It replaces no TPU kernel (the JAX package left its ICP to XLA).
- A CPU tensor goes to ``align_reference``: the corner gather from the
  slots in place (``fetch_reference``), then the arithmetic the port ran
  before the kernel, so the CPU computes what it computed then.

``launches`` counts the kernel launches made through ``align``; a call
made while a CUDA graph is captured launches nothing and is not counted
(a replay runs no Python).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from kbslam_torch.geom.se3 import SE3, quat_rotate, quat_to_matrix

SENTINEL = 4.0  # packed "unobserved" value; a real TSDF lies in [-1, 1]

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def corners(cfg, X: torch.Tensor, slot_base):
    """The trilinear neighbourhood of points X [..., 3] (grid frame):
    (flat corner indices [..., 8] int64 offset by ``slot_base``, the
    fractions per axis, inside [...]: all 8 corners in the grid)."""
    nx, ny, nz = cfg.dims
    inside = torch.ones(X.shape[:-1], dtype=torch.bool, device=X.device)
    idx, f = [], []
    for a, n in enumerate(cfg.dims):
        g = (X[..., a] - cfg.origin[a]) / cfg.voxel_size - 0.5
        i0 = torch.floor(g)
        f.append(g - i0)                                      # in [0, 1)
        inside = inside & (i0 >= 0) & (i0 <= n - 2)
        idx.append(i0.clamp(0, n - 2).to(torch.int64))
    base = (idx[0] * ny + idx[1]) * nz + idx[2] + slot_base
    # corner order: bit 2 -> +x, bit 1 -> +y, bit 0 -> +z
    k = torch.arange(8, device=X.device)
    off = ((k >> 2) * ny + ((k >> 1) & 1)) * nz + (k & 1)
    return base[..., None] + off, f, inside


def interpolate(c: torch.Tensor, f, h: float):
    """Trilinear value [...] and analytic gradient [..., 3] (per metre)
    from the 8 corner values c [..., 8] and the fractions f."""
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
    return phi, torch.stack([gx, gy, gz], dim=-1) / h


def fetch_slots(tsdf, weight, slots, anchor_q, anchor_t, cfg, X):
    """Every slot's trilinear TSDF at world points X [P, 3], read in
    place: (phi [K, P], world gradient [K, P, 3], valid [K, P]). An
    unobserved corner reads as the sentinel, as the JAX package's packed
    volume has it; valid asks for all 8 corners inside and observed."""
    K = slots.shape[0]
    V = math.prod(cfg.dims)
    if anchor_q is None:                       # world coordinates
        Xl = X.expand(K, -1, -1)
    else:                                      # X_l = R^T (X - t)
        R = quat_to_matrix(anchor_q)                             # [K, 3, 3]
        Xl = torch.matmul(X[None] - anchor_t[:, None], R)        # [K, P, 3]
    idx, f, inside = corners(cfg, Xl, (slots.to(torch.int64) * V)[:, None])
    observed = weight.reshape(-1)[idx] > 0
    c = torch.where(observed, tsdf.reshape(-1)[idx], SENTINEL)
    phis, grads = interpolate(c, f, cfg.voxel_size)
    if anchor_q is not None:                   # grad_w = R grad_l
        grads = torch.matmul(grads, R.transpose(1, 2))
    return phis, grads, inside & observed.all(dim=-1)


def fetch_reference(tsdf, weight, slots, anchor_q, anchor_t, cfg, X):
    """The model at world points X [P, 3]: (phi [P], world gradient
    [P, 3], valid [P]) of each point's first valid slot (overlapping
    submaps are slightly inconsistent rigid bodies, so their normal
    equations are not summed)."""
    phis, grads, valids = fetch_slots(tsdf, weight, slots, anchor_q,
                                      anchor_t, cfg, X)
    ks = torch.arange(slots.shape[0], device=X.device)[:, None]
    first = torch.argmax(valids.to(torch.uint8), dim=0)          # [P]
    sel = (ks == first[None]) & valids
    phi = torch.where(sel, phis, 0.0).sum(dim=0)
    grad = torch.where(sel[..., None], grads, 0.0).sum(dim=0)
    return phi, grad, valids.any(dim=0)


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
    return (X, r, g, wv) + _stats(r, wv, valid)


def _stats(r, wv, valid):
    """A fetch's (n i32, robust RMSE f32)."""
    n = valid.sum().to(torch.int32)
    rmse = torch.sqrt((wv * r * r).sum() / torch.clamp_min(wv.sum(), 1e-12))
    return n, rmse


def _gn_align(fetch, q0, t0, icp):
    """Gauss-Newton alignment from camera-to-world (q0, t0), where
    ``fetch(q, t)`` is one fetch (``_residuals``' six results):
    ``icp.iters`` trips of one fetch and one damped 6x6 solve by
    ``torch.linalg.solve_ex`` (unlike ``solve`` it makes no host sync);
    trip 0's fetch gives the initial stats and one more fetch evaluates
    the final pose."""
    q, t = q0, t0
    eye = torch.eye(6, dtype=torch.float32, device=q0.device)
    for k in range(icp.iters):
        X, r, g, wv, n, rmse = fetch(q, t)
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
        n0 = torch.zeros((), dtype=torch.int32, device=q0.device)
        rmse0 = torch.zeros((), dtype=torch.float32, device=q0.device)
    _, _, _, _, n1, rmse1 = fetch(q, t)
    return q, t, torch.minimum(n0, n1), rmse0, rmse1


def fetch_twin(tsdf, weight, slots, anchor_q, anchor_t, p_cam, p_ok, cfg,
               icp):
    """The plain twin of ``make_fetch``: ``fetch(q, t)``, one fetch by
    ``fetch_reference`` and ``_residuals``."""
    def sdf_fn(X):
        return fetch_reference(tsdf, weight, slots, anchor_q, anchor_t, cfg,
                               X)

    return functools.partial(_residuals, sdf_fn, cfg, icp, p_cam, p_ok)


def align_reference(tsdf, weight, slots, anchor_q, anchor_t, p_cam, p_ok,
                    q0, t0, cfg, icp):
    """Plain torch twin of ``align``."""
    return _gn_align(fetch_twin(tsdf, weight, slots, anchor_q, anchor_t,
                                p_cam, p_ok, cfg, icp), q0, t0, icp)


def _check(tsdf, weight, slots, anchor_q, anchor_t, p_cam, p_ok, cfg):
    """What the kernel takes: float32 contiguous [S, nx, ny, nz] slots of
    ``cfg.dims`` with fewer than 2**31 voxels each, int32 [K] slots,
    anchors [K, 4] and [K, 3] or none, float32 [P, 3] points (P < 2**29,
    so 3 * P fits an int), bool [P] validity, all on one device
    (``_check_pose`` checks the start pose). Only what the host knows is
    checked: the slot values stay on the device."""
    dev = tsdf.device
    tensors = dict(tsdf=tsdf, weight=weight, slots=slots, p_cam=p_cam,
                   p_ok=p_ok)
    if (anchor_q is None) != (anchor_t is None):
        raise ValueError("icp.align: anchor_q and anchor_t come together")
    if anchor_q is not None:
        tensors.update(anchor_q=anchor_q, anchor_t=anchor_t)
    for name, x in tensors.items():
        if x.device != dev:
            raise ValueError(f"icp.align: {name} is on {x.device}, the "
                             f"slots on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"icp.align: {name} must be contiguous")
        want = (torch.int32 if name == "slots" else
                torch.bool if name == "p_ok" else torch.float32)
        if x.dtype != want:
            raise ValueError(f"icp.align: {name} must be {want}, got "
                             f"{x.dtype}")
    K, P = slots.shape[0], p_cam.shape[0]
    shapes = dict(tsdf=(tsdf.shape[0], *cfg.dims),
                  weight=tuple(tsdf.shape), slots=(K,), p_cam=(P, 3),
                  p_ok=(P,), anchor_q=(K, 4), anchor_t=(K, 3))
    for name, x in tensors.items():
        if tuple(x.shape) != shapes[name]:
            raise ValueError(f"icp.align: {name} must be {shapes[name]}, "
                             f"got {tuple(x.shape)}")
    if (K == 0 or P == 0 or min(cfg.dims) < 2
            or math.prod(cfg.dims) >= 2 ** 31 or P >= 2 ** 29):
        raise ValueError(f"icp.align: unsupported shapes: slots "
                         f"{tuple(tsdf.shape)}, K {K}, P {P}")


def _check_pose(q, t, dev):
    """What the kernel takes as a pose: float32 [4] and [3] on ``dev``."""
    if (q.dtype, t.dtype, q.shape, t.shape, q.device, t.device) != (
            torch.float32, torch.float32, (4,), (3,), dev, dev):
        raise ValueError(f"icp.align: the pose must be float32 [4] and [3] "
                         f"on {dev}, got {q.dtype} {tuple(q.shape)} on "
                         f"{q.device} and {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def make_fetch(tsdf, weight, slots, anchor_q, anchor_t, p_cam, p_ok, cfg,
               icp):
    """``fetch(q, t)``: one fetch at the pose, ``_residuals``' six results.
    On the card one launch of the kernel, which gives ``fetch_twin``'s
    bits, then torch's count and RMSE; on the CPU ``fetch_twin``. The
    pose is the caller's to check (``align`` checks its start pose once;
    the later ones come from ``_gn_align``'s SE3 arithmetic)."""
    if tsdf.device.type == "cpu":
        return fetch_twin(tsdf, weight, slots, anchor_q, anchor_t, p_cam,
                          p_ok, cfg, icp)
    if tsdf.device.type != "cuda":
        raise ValueError(f"icp.align: unsupported device {tsdf.device}")
    _check(tsdf, weight, slots, anchor_q, anchor_t, p_cam, p_ok, cfg)
    from kbslam_torch.ops._build import build

    lib = build().lib
    dev = tsdf.device
    P = p_cam.shape[0]
    # the twin divides by the voxel size as torch divides by a Python
    # float on the card: a product by the double reciprocal 1 / h rounded
    # to float32 (not 1.0f / (float)h, which differs at h = 0.03;
    # tests/test_torch_cuda.py holds a 3 cm volume to the twin's bits)
    inv_h = float(np.float32(1.0 / cfg.voxel_size))
    # every launch reads R: the closure below holds it, so its memory is
    # not handed to another tensor while the solve runs
    R = None if anchor_q is None else quat_to_matrix(anchor_q).contiguous()
    grid = (*cfg.dims, *cfg.origin, inv_h, cfg.truncation, icp.huber_m)

    def fetch(q, t):
        global launches
        q, t = q.contiguous(), t.contiguous()
        X, g = torch.empty_like(p_cam), torch.empty_like(p_cam)
        r, wv = (torch.empty(P, dtype=torch.float32, device=dev)
                 for _ in range(2))
        valid = torch.empty(P, dtype=torch.bool, device=dev)
        with torch.cuda.device(dev):
            err = lib.kbslam_icp_fetch(
                tsdf.data_ptr(), weight.data_ptr(), tsdf.shape[0],
                math.prod(cfg.dims), slots.data_ptr(), slots.shape[0],
                None if R is None else R.data_ptr(),
                None if anchor_t is None else anchor_t.data_ptr(),
                p_cam.data_ptr(), p_ok.data_ptr(), P, q.data_ptr(),
                t.data_ptr(), *grid, X.data_ptr(), r.data_ptr(), g.data_ptr(),
                wv.data_ptr(), valid.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            msg = lib.kbslam_cuda_error_string(err).decode()
            raise RuntimeError(f"icp fetch kernel launch failed: {msg}")
        if not torch.cuda.is_current_stream_capturing():
            launches += 1
        return (X, r, g, wv) + _stats(r, wv, valid)

    return fetch


def align(tsdf, weight, slots, anchor_q, anchor_t, p_cam, p_ok, q0, t0, cfg,
          icp):
    """(q, t, num_valid, rmse_init, rmse) of the solve from camera-to-world
    (q0, t0), for points ``p_cam`` [P, 3] in the camera frame with
    validity ``p_ok`` [P] (see the module's docstring)."""
    fetch = make_fetch(tsdf, weight, slots, anchor_q, anchor_t, p_cam, p_ok,
                       cfg, icp)
    if tsdf.device.type == "cuda":
        _check_pose(q0, t0, tsdf.device)
    return _gn_align(fetch, q0, t0, icp)
