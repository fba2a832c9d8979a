"""Synthetic RGB-D sequence generator with exact ground truth.

The port's own copy of ``kbslam/io/synthetic.py``, unchanged below this
docstring; tests/test_torch_copies.py holds the two equal.

The reference is validated only visually against a live camera stream;
our test pyramid needs deterministic data with known trajectories
(SURVEY §4). A camera flies in front of a corner-rich textured plane;
each frame is ray-cast analytically, producing RGB + uint16 depth (mm)
+ optional static-element mask, plus the exact camera-to-world pose.
Host-side NumPy: this is ingress, not device compute.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np


class SyntheticSequence(NamedTuple):
    rgb: np.ndarray     # [T, H, W, 3] uint8
    depth: np.ndarray   # [T, H, W] uint16 (mm)
    mask: np.ndarray    # [T, H, W] uint8 (255 = static/keep)
    poses: np.ndarray   # [T, 4, 4] T_wc ground truth
    K: np.ndarray       # [3, 3]


def _texture(rng: np.random.Generator, size: int = 1024,
             num_rects: int = 600) -> np.ndarray:
    """Corner-rich RGB texture (num_rects controls texture density —
    low values make a low-texture scene that starves the detector)."""
    tex = np.full((size, size, 3), 40, np.float32)
    for _ in range(num_rects):
        x, y = rng.integers(0, size - 40, size=2)
        w, h = rng.integers(8, 80, size=2)
        color = rng.integers(30, 255, size=3)
        tex[y : y + h, x : x + w] = color
    # mild blur to avoid aliasing shimmer
    k = np.array([0.25, 0.5, 0.25])
    for ax in (0, 1):
        tex = (
            0.5 * tex
            + 0.25 * np.roll(tex, 1, axis=ax)
            + 0.25 * np.roll(tex, -1, axis=ax)
        )
    return tex


def _rotz(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])


def _roty(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1.0, 0], [-s, 0, c]])


def _rotx(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1.0, 0, 0], [0, c, -s], [0, s, c]])


def default_trajectory(num_frames: int, amplitude: float = 0.6) -> np.ndarray:
    """Smooth sideways sweep with gentle yaw/pitch; camera ~2.5 m from the
    plane, looking +z (plane at z = 0 in world, camera starts at z=-2.5)."""
    poses = []
    for i in range(num_frames):
        s = i / max(num_frames - 1, 1)
        t = np.array(
            [amplitude * np.sin(2 * np.pi * s),
             0.3 * np.sin(4 * np.pi * s),
             -2.5 + 0.4 * np.sin(2 * np.pi * s + 1.0)]
        )
        R = _roty(0.08 * np.sin(2 * np.pi * s)) @ _rotx(0.05 * np.cos(2 * np.pi * s))
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = t
        poses.append(T)
    return np.stack(poses)


def rotation_trajectory(num_frames: int, yaw_amplitude: float = 0.45,
                        translation: float = 0.15) -> np.ndarray:
    """Rotation-dominant sweep: the camera pans +/- yaw_amplitude rad
    (~ +/-26 deg default) with only small translation — the keyframe
    policy's 5-degree trigger fires from rotation, baselines stay short,
    and depth-from-parallax is weak. Stresses the policy/BA interplay
    the smooth sideways default cannot (VERDICT r2 weak #7)."""
    poses = []
    for i in range(num_frames):
        s = i / max(num_frames - 1, 1)
        t = np.array([translation * np.sin(2 * np.pi * s),
                      0.5 * translation * np.sin(4 * np.pi * s),
                      -2.5 + translation * np.cos(2 * np.pi * s)])
        R = _roty(yaw_amplitude * np.sin(2 * np.pi * s)) @ _rotx(
            0.3 * yaw_amplitude * np.cos(2 * np.pi * s))
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = t
        poses.append(T)
    return np.stack(poses)


def corridor_trajectory(num_frames: int, advance: float = 4.0,
                        yaw_amplitude: float = 0.5) -> np.ndarray:
    """Forward flight down a corridor with large yaw sweeps (~ +/-29 deg
    default): the view alternates between the near side walls (~1.5 m)
    and the far end wall (~8 m) — the depth-range mix and
    rotation-under-translation case the plane families never produce."""
    poses = []
    for i in range(num_frames):
        s = i / max(num_frames - 1, 1)
        t = np.array([0.3 * np.sin(2 * np.pi * s),
                      0.15 * np.sin(4 * np.pi * s),
                      -2.5 + advance * s])
        R = _roty(yaw_amplitude * np.sin(2 * np.pi * s)) @ _rotx(
            0.1 * np.cos(2 * np.pi * s))
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = t
        poses.append(T)
    return np.stack(poses)


def render_sequence(
    num_frames: int = 60,
    height: int = 240,
    width: int = 320,
    fx: float = 260.0,
    seed: int = 0,
    poses: Optional[np.ndarray] = None,
    moving_box: bool = False,
    scene: str = "plane",        # "plane" | "spheres" | "corridor"
    depth_noise_mm: float = 0.0,  # sensor-style sigma at 1 m (grows with z^2)
    depth_dropout: float = 0.0,   # fraction of pixels with depth holes
    texture_rects: int = 600,     # texture density (low = feature-starved)
    specular: float = 0.0,        # view-dependent gloss strength (0-1):
    # a moving highlight washes out texture and sheds non-repeatable
    # rim gradients — the specular/low-texture failure family
    hole_blobs: int = 0,          # depth-hole disks per frame (sensor
    # dropout comes in blobs, not iid pixels)
) -> SyntheticSequence:
    rng = np.random.default_rng(seed)
    tex = _texture(rng, num_rects=texture_rects)
    tex_size = tex.shape[0]
    plane_extent = 4.0  # plane spans [-4, 4] m in x and y

    # non-planar structure: textured spheres floating between the camera
    # path (z < 0) and the plane (z = 0) — parallax, occlusion boundaries,
    # and curved depth gradients the flat plane lacks
    if scene == "spheres":
        n_sph = 10
        sph_c = np.stack([
            rng.uniform(-2.2, 2.2, n_sph),
            rng.uniform(-2.2, 2.2, n_sph),
            rng.uniform(-1.3, -0.35, n_sph),
        ], axis=1).astype(np.float32)
        sph_r = rng.uniform(0.18, 0.45, n_sph).astype(np.float32)
    elif scene == "corridor":
        # axis-aligned box interior: side walls x=+/-wx, floor/ceiling
        # y=+/-wy, end walls z=z_end (far) / z_back (behind the start)
        cor_wx, cor_wy = 1.5, 1.2
        cor_zend, cor_zback = 6.0, -5.0
    elif scene != "plane":
        raise ValueError(f"unknown scene {scene!r}")

    K = np.array(
        [[fx, 0, (width - 1) / 2.0], [0, fx, (height - 1) / 2.0], [0, 0, 1.0]]
    )
    if poses is None:
        poses = (corridor_trajectory(num_frames) if scene == "corridor"
                 else default_trajectory(num_frames))

    us, vs = np.meshgrid(np.arange(width, dtype=np.float32),
                         np.arange(height, dtype=np.float32))
    dirs = np.stack(
        [(us - K[0, 2]) / K[0, 0], (vs - K[1, 2]) / K[1, 1],
         np.ones_like(us, np.float32)],
        axis=-1,
    ).astype(np.float32)  # [H, W, 3] camera-frame rays with z = 1

    rgbs, depths, masks = [], [], []
    for ti in range(num_frames):
        T = poses[ti]
        R, t = T[:3, :3].astype(np.float32), T[:3, 3].astype(np.float32)
        d_world = dirs @ R.T                     # [H, W, 3]
        dz = d_world[..., 2]
        if scene == "corridor":
            # nearest positive hit among the 6 interior faces (the
            # camera stays inside, so each axis contributes the face
            # the ray points toward)
            dx, dy = d_world[..., 0], d_world[..., 1]
            eps = 1e-9
            sx = np.where(np.abs(dx) > eps,
                          np.where(dx > 0, cor_wx - t[0], -cor_wx - t[0])
                          / np.where(np.abs(dx) > eps, dx, 1.0), 1e9)
            sy = np.where(np.abs(dy) > eps,
                          np.where(dy > 0, cor_wy - t[1], -cor_wy - t[1])
                          / np.where(np.abs(dy) > eps, dy, 1.0), 1e9)
            sz = np.where(np.abs(dz) > eps,
                          np.where(dz > 0, cor_zend - t[2], cor_zback - t[2])
                          / np.where(np.abs(dz) > eps, dz, 1.0), 1e9)
            faces = np.stack([np.where(sx > 0.05, sx, 1e9),
                              np.where(sy > 0.05, sy, 1e9),
                              np.where(sz > 0.05, sz, 1e9)])
            s = faces.min(0)
            which_face = faces.argmin(0)  # 0=x-wall, 1=y-wall, 2=z-wall
            hit = (s > 0.05) & (s < 40.0)
        else:
            # plane z = 0: t_z + s * d_z = 0
            s = np.where(np.abs(dz) > 1e-9, -t[2] / dz, 1e9)
            hit = (s > 0.05) & (s < 40.0)
        if scene == "spheres":
            # nearest positive ray-sphere hit, occluding the plane
            o_c = t[None, None, None, :] - sph_c[None, None, :, :]  # [H,W,S,3]
            a = np.sum(d_world * d_world, -1)[..., None]            # [H,W,1]
            b = 2.0 * np.einsum("hwd,hwsd->hws", d_world, o_c)
            cterm = np.sum(o_c * o_c, -1) - (sph_r * sph_r)[None, None, :]
            disc = b * b - 4.0 * a * cterm
            sq = np.sqrt(np.maximum(disc, 0.0))
            s_sph = np.where(disc > 0, (-b - sq) / (2.0 * a), 1e9)
            s_sph = np.where(s_sph > 0.05, s_sph, 1e9)
            s_near = s_sph.min(-1)
            which = s_sph.argmin(-1)
            sph_hit = s_near < s
            # texture spheres by surface normal (high-frequency detail)
            pt_s = t[None, None, :] + s_near[..., None] * d_world
            nrm = (pt_s - sph_c[which]) / sph_r[which][..., None]
            # coarse texture window (~96 px per sphere): full-resolution
            # mapping would minify 1024 texels onto a ~30 px silhouette
            # and alias into non-repeatable descriptors
            sph_u = (nrm[..., 0] * 0.5 + 0.5) * 95 + which * 83 % (tex_size - 96)
            sph_v = (nrm[..., 1] * 0.5 + 0.5) * 95 + which * 131 % (tex_size - 96)
            sph_col = tex[np.clip(sph_v.astype(int), 0, tex_size - 1),
                          np.clip(sph_u.astype(int), 0, tex_size - 1)]
            s = np.where(sph_hit, s_near, s)
            hit = hit | sph_hit
        if moving_box:
            # A textured rigid object translating through the scene at
            # its own depth plane — a REAL dynamic object: its features
            # are corner-rich (attract ORB), carry consistent depth, and
            # move together as a rigid wrong-motion cluster, which is
            # exactly what the reference's static-element mask exists to
            # reject (VisualOdometry.cpp:30, Camera mask ingress). A
            # solid painted square only contributes 4 corners and never
            # stresses the mask path.
            box_z, box_hw = -1.0, 0.35
            prog = ti / max(num_frames - 1, 1)
            box_cx = -0.8 + 1.6 * prog
            box_cy = 0.25 * np.sin(2 * np.pi * prog)
            s_box = np.where(np.abs(dz) > 1e-9, (box_z - t[2]) / dz, 1e9)
            pt_b = t[None, None, :] + s_box[..., None] * d_world
            in_box = ((s_box > 0.05) & (s_box < s)
                      & (np.abs(pt_b[..., 0] - box_cx) < box_hw)
                      & (np.abs(pt_b[..., 1] - box_cy) < box_hw))
            # texture anchored to the box (scrolls with it): descriptors
            # stay repeatable frame-to-frame at the WRONG image motion
            bwin, boff = 160, tex_size - 200
            bu = ((pt_b[..., 0] - box_cx) / box_hw * 0.5 + 0.5) * (bwin - 1)
            bv = ((pt_b[..., 1] - box_cy) / box_hw * 0.5 + 0.5) * (bwin - 1)
            box_col = tex[boff + np.clip(bv.astype(int), 0, bwin - 1),
                          boff + np.clip(bu.astype(int), 0, bwin - 1)]
            s = np.where(in_box, s_box, s)
            hit = hit | in_box
        pt = t[None, None, :] + s[..., None] * d_world
        # depth along camera z axis == s (rays have unit camera z)
        depth_m = np.where(hit, s, 0.0)

        # texture lookup (bilinear)
        if scene == "corridor":
            # per-face planar uv in metres (x-walls: (z,y); y-walls:
            # (z,x); z-walls: (x,y)), wrapped every 8 m; each face gets
            # its own texture offset so opposite walls don't alias into
            # identical descriptors
            u_m = np.where(which_face == 2, pt[..., 0], pt[..., 2])
            v_m = np.where(which_face == 0, pt[..., 1],
                           np.where(which_face == 1, pt[..., 0],
                                    pt[..., 1]))
            face_dir = np.stack([d_world[..., 0], d_world[..., 1], dz])
            side = np.take_along_axis(face_dir, which_face[None], 0)[0] > 0
            off = which_face * 0.271 + side * 0.523
            txf = ((u_m / 8.0 + off) % 1.0) * (tex_size - 1)
            tyf = ((v_m / 8.0 + 0.37 * off) % 1.0) * (tex_size - 1)
            inside = hit
        else:
            txf = (pt[..., 0] / plane_extent * 0.5 + 0.5) * (tex_size - 1)
            tyf = (pt[..., 1] / plane_extent * 0.5 + 0.5) * (tex_size - 1)
            inside = hit & (txf >= 0) & (txf < tex_size - 1) & (tyf >= 0) & (tyf < tex_size - 1)
        tx0 = np.clip(txf.astype(int), 0, tex_size - 2)
        ty0 = np.clip(tyf.astype(int), 0, tex_size - 2)
        fxq = (txf - tx0)[..., None]
        fyq = (tyf - ty0)[..., None]
        c00 = tex[ty0, tx0]
        c01 = tex[ty0, tx0 + 1]
        c10 = tex[ty0 + 1, tx0]
        c11 = tex[ty0 + 1, tx0 + 1]
        color = (
            c00 * (1 - fxq) * (1 - fyq)
            + c01 * fxq * (1 - fyq)
            + c10 * (1 - fxq) * fyq
            + c11 * fxq * fyq
        )
        if scene == "spheres":
            color = np.where(sph_hit[..., None], sph_col, color)
            inside = inside | sph_hit
        if moving_box:
            color = np.where(in_box[..., None], box_col, color)
            inside = inside | in_box
        if specular:
            # Blinn-style gloss with the camera in the half-vector: the
            # highlight MOVES as the camera moves, so its washed-out
            # interior starves the detector and its rim sheds bright
            # gradients that are not redetectable at the same surface
            # point next frame
            light = np.array([0.6, -0.8, -2.2], np.float32)
            vdir = t[None, None, :] - pt
            vdir = vdir / np.maximum(
                np.linalg.norm(vdir, axis=-1, keepdims=True), 1e-6)
            ldir = light[None, None, :] - pt
            ldir = ldir / np.maximum(
                np.linalg.norm(ldir, axis=-1, keepdims=True), 1e-6)
            h = vdir + ldir
            h = h / np.maximum(np.linalg.norm(h, axis=-1, keepdims=True),
                               1e-6)
            spec = np.clip(-h[..., 2], 0.0, 1.0) ** 48
            color = color + 255.0 * specular * spec[..., None]
        rgb = np.where(inside[..., None], np.clip(color, 0, 255),
                       0.0).astype(np.uint8)
        depth_vis = np.where(inside, depth_m, 0.0)
        if depth_noise_mm:
            # sensor model: sigma grows quadratically with range
            # (Kinect-style), plus optional dropout holes
            sig = depth_noise_mm * 1e-3 * np.maximum(depth_vis, 0.3) ** 2
            depth_vis = np.where(depth_vis > 0,
                                 depth_vis + rng.normal(size=depth_vis.shape)
                                 * sig, 0.0)
        if depth_dropout:
            keep = rng.random(depth_vis.shape) >= depth_dropout
            depth_vis = depth_vis * keep
        if hole_blobs:
            # blob-shaped sensor dropout: real depth holes cluster
            # (specular surfaces, IR shadows), they are not iid pixels
            for _ in range(hole_blobs):
                hx = rng.uniform(0, width)
                hy = rng.uniform(0, height)
                hr = rng.uniform(8.0, 0.12 * min(height, width) + 8.0)
                blob = (us - hx) ** 2 + (vs - hy) ** 2 < hr * hr
                depth_vis = np.where(blob, 0.0, depth_vis)
        depth_mm = np.clip(depth_vis * 1000.0, 0, 65535).astype(np.uint16)
        mask = np.full((height, width), 255, np.uint8)
        if moving_box:
            mask[in_box] = 0

        rgbs.append(rgb)
        depths.append(depth_mm)
        masks.append(mask)

    return SyntheticSequence(
        np.stack(rgbs), np.stack(depths), np.stack(masks), poses, K
    )
