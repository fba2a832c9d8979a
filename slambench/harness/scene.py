"""The benchmark's camera: a seeded textured plane, ray-cast on the device.

A PyTorch copy of the plane scene of ``kbslam_torch/io/synthetic.py``
(``_texture``, the plane ray cast, the bilinear texture lookup, depth
in millimetres), kept here so that later changes to the program leave
the yardstick alone. The camera flies a periodic sweep: after
``period`` frames it is back where it started, so a driver cycles
through one period of frames for as long as it runs.

The texture comes from the seed exactly as in ``synthetic.py``
(``numpy.random.default_rng(seed)``, 600 rectangles, a mild blur); the
frames are rendered on the device in a few batched calls and then copied
to host memory, where a camera's frames arrive.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

PLANE_EXTENT = 4.0      # the plane spans [-4, 4] m in x and y, at z = 0


class Sweep(NamedTuple):
    """Amplitudes of the periodic sweep: translation (m) and rotation
    (rad). x, yaw and roll run one cycle per period, y and pitch two,
    z one with a phase of 1 rad."""

    x: float
    y: float
    z: float
    yaw: float
    pitch: float
    roll: float


def texture(seed: int, size: int = 1024, num_rects: int = 600) -> np.ndarray:
    """Corner-rich RGB texture [size, size, 3] float32 (``synthetic._texture``
    with ``default_rng(seed)``)."""
    rng = np.random.default_rng(seed)
    tex = np.full((size, size, 3), 40, np.float32)
    for _ in range(num_rects):
        x, y = rng.integers(0, size - 40, size=2)
        w, h = rng.integers(8, 80, size=2)
        color = rng.integers(30, 255, size=3)
        tex[y:y + h, x:x + w] = color
    for ax in (0, 1):
        tex = (0.5 * tex + 0.25 * np.roll(tex, 1, axis=ax)
               + 0.25 * np.roll(tex, -1, axis=ax))
    return tex


def _rot(axis: str, a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    if axis == "x":
        return np.array([[1.0, 0, 0], [0, c, -s], [0, s, c]])
    if axis == "y":
        return np.array([[c, 0, s], [0, 1.0, 0], [-s, 0, c]])
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])


def sweep_poses(period: int, amp: Sweep, distance: float = 2.5,
                phase: int = 0) -> np.ndarray:
    """[period, 4, 4] camera-to-world poses, frame i of the sweep started
    ``phase`` frames in; the camera looks along +z at the plane from
    ``distance`` metres."""
    poses = []
    for i in range(period):
        s = 2 * math.pi * ((i + phase) % period) / period
        T = np.eye(4)
        T[:3, 3] = [amp.x * math.sin(s), amp.y * math.sin(2 * s),
                    -distance + amp.z * math.sin(s + 1.0)]
        T[:3, :3] = (_rot("y", amp.yaw * math.sin(s))
                     @ _rot("x", amp.pitch * math.cos(2 * s))
                     @ _rot("z", amp.roll * math.sin(s + 0.5)))
        poses.append(T)
    return np.stack(poses)


def mean_speeds(poses: np.ndarray, hz: float) -> tuple:
    """(m/s, deg/s): the mean translational and angular speed of a
    periodic sequence of poses played at ``hz``."""
    n = len(poses)
    v = w = 0.0
    for i in range(n):
        a, b = poses[i], poses[(i + 1) % n]
        v += float(np.linalg.norm(b[:3, 3] - a[:3, 3]))
        dR = a[:3, :3].T @ b[:3, :3]
        w += math.acos(min(1.0, max(-1.0, (np.trace(dR) - 1) / 2)))
    return v / n * hz, math.degrees(w / n) * hz


def render(tex: torch.Tensor, poses: torch.Tensor, fx: float, height: int,
           width: int, batch: int = 16):
    """(rgb [T, H, W, 3] uint8, depth [T, H, W] int32 millimetres) of the
    plane seen from ``poses`` [T, 4, 4], on ``tex``'s device, ``batch``
    frames per call: ``synthetic.render_sequence``'s plane scene."""
    dev = tex.device
    size = tex.shape[0]
    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    v, u = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=dev),
                          torch.arange(width, dtype=torch.float32, device=dev),
                          indexing="ij")
    dirs = torch.stack([(u - cx) / fx, (v - cy) / fx, torch.ones_like(u)], -1)
    rgbs, depths = [], []
    for b in range(0, poses.shape[0], batch):
        T = poses[b:b + batch].to(device=dev, dtype=torch.float32)
        R, t = T[:, :3, :3], T[:, :3, 3]
        d = torch.einsum("hwj,bij->bhwi", dirs, R)          # dirs @ R.T
        dz = d[..., 2]
        tz = t[:, 2, None, None]
        s = torch.where(dz.abs() > 1e-9, -tz / torch.where(dz.abs() > 1e-9,
                                                           dz, 1.0), 1e9)
        hit = (s > 0.05) & (s < 40.0)
        pt = t[:, None, None, :] + s[..., None] * d
        txf = (pt[..., 0] / PLANE_EXTENT * 0.5 + 0.5) * (size - 1)
        tyf = (pt[..., 1] / PLANE_EXTENT * 0.5 + 0.5) * (size - 1)
        inside = (hit & (txf >= 0) & (txf < size - 1) & (tyf >= 0)
                  & (tyf < size - 1))
        tx0 = txf.to(torch.int64).clamp(0, size - 2)
        ty0 = tyf.to(torch.int64).clamp(0, size - 2)
        fxq = (txf - tx0)[..., None]
        fyq = (tyf - ty0)[..., None]
        color = (tex[ty0, tx0] * (1 - fxq) * (1 - fyq)
                 + tex[ty0, tx0 + 1] * fxq * (1 - fyq)
                 + tex[ty0 + 1, tx0] * (1 - fxq) * fyq
                 + tex[ty0 + 1, tx0 + 1] * fxq * fyq)
        rgbs.append(torch.where(inside[..., None], color.clamp(0, 255),
                                0.0).to(torch.uint8))
        depth_m = torch.where(inside, s, 0.0)
        depths.append((depth_m * 1000.0).clamp(0, 65535).to(torch.int32))
    return torch.cat(rgbs), torch.cat(depths)


def intrinsics(camera: dict) -> np.ndarray:
    """The 3x3 camera matrix of a configuration's ``camera``."""
    return np.array([[camera["fx"], 0, (camera["width"] - 1) / 2.0],
                     [0, camera["fx"], (camera["height"] - 1) / 2.0],
                     [0, 0, 1.0]])


def camera_frames(config: dict, seed: int, device, streams: int = 1):
    """Every stream's period of frames, rendered on ``device`` from the
    seed: (rgb [P, S, H, W, 3] uint8, depth [P, S, H, W] int32, poses
    [P, S, 4, 4] float64). Stream s has texture seed ``seed + s`` and
    starts ``s * P / S`` frames into the sweep."""
    cam, sc = config["camera"], config["scene"]
    P = int(sc["period_frames"])
    amp = Sweep(**sc["sweep"])
    rgb, depth, poses = [], [], []
    for s in range(streams):
        tex = torch.from_numpy(texture(seed + s, num_rects=sc["texture_rects"]))
        pose = sweep_poses(P, amp, sc["distance_m"], phase=s * P // streams)
        r, d = render(tex.to(device), torch.from_numpy(pose), cam["fx"],
                      cam["height"], cam["width"])
        rgb.append(r)
        depth.append(d)
        poses.append(pose)
    return (torch.stack(rgb, 1), torch.stack(depth, 1),
            np.stack(poses, 1))
