"""Rerun visualization egress with the reference's entity-path schema: the
port's own copy of kbslam/viz/rerun_viewer.py, equal to it below this
docstring but for the package name of its one import (the port's
``geom.camera.to_display_coords``, in torch).

Mirrors Viewer.cpp: stream "Visual Odometry"; per frame log of
  /world/trajectory/points     blue LineStrip3D   (Viewer.cpp:24)
  /world/trajectory/keyframes  red Points3D r=0.5 (Viewer.cpp:38)
  /world/trajectory/map        green Points3D r=0.05 (Viewer.cpp:52)
  /camera/0/rgb                RGB image          (Viewer.cpp:59)
  /camera/0/depth              colormapped depth (scale 0.02) (Viewer.cpp:66-68)
  /camera/0/mask               mask image         (Viewer.cpp:83)
with the display-coordinate remap (x, -z, -y) applied to geometry
(Map.cpp:86,96). Without the ``rerun`` SDK the viewer is a recorder
that logs nothing and keeps the last logged state in ``Viewer.last``;
with it, it streams or spawns like the reference (Viewer.cpp:9).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

try:
    import rerun as rr  # noqa: F401

    HAVE_RERUN = True
except Exception:  # pragma: no cover - rerun not in image
    HAVE_RERUN = False

from kbslam_torch.geom.camera import to_display_coords  # noqa: F401  (device-side twin)


def _remap(points: np.ndarray) -> np.ndarray:
    """(x, y, z) -> (x, -z, -y), host-side (Map.cpp:86,96)."""
    if len(points) == 0:
        return points.reshape(0, 3)
    return np.stack([points[:, 0], -points[:, 2], -points[:, 1]], axis=-1)


def jet_colormap(v: np.ndarray) -> np.ndarray:
    """uint8 [H, W] -> RGB uint8 [H, W, 3], the classic JET ramp
    (blue -> cyan -> yellow -> red), matching cv::applyColorMap(JET)'s
    piecewise-linear form."""
    x = v.astype(np.float32) / 255.0
    r = np.clip(1.5 - np.abs(4.0 * x - 3.0), 0.0, 1.0)
    g = np.clip(1.5 - np.abs(4.0 * x - 2.0), 0.0, 1.0)
    b = np.clip(1.5 - np.abs(4.0 * x - 1.0), 0.0, 1.0)
    return (np.stack([r, g, b], axis=-1) * 255.0 + 0.5).astype(np.uint8)


def colorize_depth(depth: np.ndarray, alpha: float = 0.02) -> np.ndarray:
    """The reference's depth display transform (Viewer.cpp:66-68):
    cv::convertScaleAbs(depth, alpha) then cv::applyColorMap(JET)."""
    v = np.clip(np.abs(depth.astype(np.float64)) * alpha + 0.5,
                0, 255).astype(np.uint8)
    return jet_colormap(v)


#: Declarative layout spec — the analogue of the reference's checked-in
#: ``visual_odometry.rbl`` blueprint (Viewer.cpp:8 loads it; the file is
#: binary RRF2 so the layout is re-stated here: one 3D world view plus
#: the three camera image feeds). Kept as data so it is testable without
#: the SDK and renderable with it.
BLUEPRINT_SPEC = {
    "world": {"kind": "3d", "origin": "/world"},
    "rgb": {"kind": "2d", "origin": "/camera/0/rgb"},
    "depth": {"kind": "2d", "origin": "/camera/0/depth"},
    "mask": {"kind": "2d", "origin": "/camera/0/mask"},
}


#: Entity paths logged every frame by Viewer.update (Viewer.cpp:24-83).
LOGGED_PATHS = (
    "/world/trajectory/points",
    "/world/trajectory/keyframes",
    "/world/trajectory/map",
    "/camera/0/rgb",
    "/camera/0/depth",
    "/camera/0/mask",
)


def scan_blueprint_entity_paths(rbl_path: str) -> set:
    """Extract entity-path-like strings from a binary Rerun blueprint
    (.rbl, RRF2 container — the reference checks in
    ``visual_odometry.rbl``, loaded by Viewer.cpp:8).

    The container stores length-prefixed strings inside LZ4-style
    compressed blocks, so a byte scan sees paths with occasional
    artifacts: a trailing length/tag byte glued on ("camera/0/depth2")
    or a head truncated by a compression back-reference
    ("/camera/0/dep"). We return the raw candidates; callers should
    treat a candidate as matching a known path when either is a string
    prefix of the other (see tests/test_io.py blueprint-binding test).
    """
    import re

    data = open(rbl_path, "rb").read()
    cands = set()
    for raw in re.findall(rb"/?(?:world|camera)[A-Za-z0-9_/]*", data):
        s = raw.decode().rstrip("/").lstrip("/")
        if s:
            cands.add("/" + s)
    return cands


def make_blueprint():
    """Build the rerun Blueprint from BLUEPRINT_SPEC: 3D world view on
    the left, the rgb/depth/mask feeds stacked on the right. Returns
    None when the SDK is absent (callers no-op, like the viewer)."""
    if not HAVE_RERUN:
        return None
    import rerun.blueprint as rrb

    views = {
        "3d": rrb.Spatial3DView,
        "2d": rrb.Spatial2DView,
    }
    cam = [views[s["kind"]](origin=s["origin"], name=name)
           for name, s in BLUEPRINT_SPEC.items() if name != "world"]
    w = BLUEPRINT_SPEC["world"]
    return rrb.Blueprint(
        rrb.Horizontal(
            views[w["kind"]](origin=w["origin"], name="world"),
            rrb.Vertical(*cam),
            column_shares=[3, 1],
        )
    )


class Viewer:
    def __init__(self, app_name: str = "Visual Odometry", spawn: bool = True,
                 depth_display_alpha: float = 0.02):
        """depth_display_alpha: raw-depth -> 8-bit scale for the JET
        display (the reference hardcodes 0.02 for its millimetric
        camera; TUM's 1/5000-scale raw depth wants ~0.004)."""
        self.enabled = HAVE_RERUN
        self.depth_display_alpha = depth_display_alpha
        self.last = {}
        if self.enabled:
            rr.init(app_name, spawn=spawn,
                    default_blueprint=make_blueprint())

    def update(
        self,
        trajectory: np.ndarray,       # [T, 3] camera positions (world)
        keyframes: np.ndarray,        # [K, 3]
        map_points: np.ndarray,       # [P, 3]
        rgb: Optional[np.ndarray] = None,
        depth: Optional[np.ndarray] = None,
        mask: Optional[np.ndarray] = None,
    ):
        traj = _remap(np.asarray(trajectory, np.float64))
        kfs = _remap(np.asarray(keyframes, np.float64))
        mps = _remap(np.asarray(map_points, np.float64))
        depth_rgb = (colorize_depth(depth, self.depth_display_alpha)
                     if depth is not None else None)
        self.last = dict(trajectory=traj, keyframes=kfs, map=mps,
                         depth_rgb=depth_rgb)
        if not self.enabled:
            return
        rr.log("/world/trajectory/points",
               rr.LineStrips3D([traj], colors=[[0, 0, 255]]))
        rr.log("/world/trajectory/keyframes",
               rr.Points3D(kfs, colors=[[255, 0, 0]], radii=0.5))
        rr.log("/world/trajectory/map",
               rr.Points3D(mps, colors=[[0, 255, 0]], radii=0.05))
        if rgb is not None:
            rr.log("/camera/0/rgb", rr.Image(rgb))
        if depth_rgb is not None:
            # JET-colorized like the reference (Viewer.cpp:66-68), not a
            # raw DepthImage with a guessed meter scale
            rr.log("/camera/0/depth", rr.Image(depth_rgb))
        if mask is not None:
            rr.log("/camera/0/mask", rr.Image(mask))

    def update_rendered(self, depth_raw: np.ndarray):
        """Log the model-PREDICTED depth view (mapping/raycast.py) under
        /camera/0/rendered — the KinectFusion-style rendered view next
        to the live /camera/0/depth feed (capability extension beyond
        the reference's Viewer.cpp schema). ``depth_raw`` must be in
        the SAME raw sensor units as the live depth feed (the caller
        divides metric render depth by MapConfig.depth_scale) so both
        panes share the JET transform and are visually comparable.
        Call at the keyframe cadence — the model only changes on
        fusion."""
        rendered = colorize_depth(depth_raw, self.depth_display_alpha)
        self.last["rendered_rgb"] = rendered
        if not self.enabled:
            return
        rr.log("/camera/0/rendered", rr.Image(rendered))

    def update_dense(self, surface_points: np.ndarray):
        """Log the TSDF zero-crossing cloud (capability extension —
        beyond the reference's Viewer.cpp schema; same (x,−z,−y)
        display remap as the sparse streams). Call at the keyframe
        cadence, not per frame — the cloud only changes on fusion."""
        pts = _remap(np.asarray(surface_points, np.float64))
        self.last["dense"] = pts
        if not self.enabled:
            return
        rr.log("/world/dense",
               rr.Points3D(pts, colors=[[200, 200, 200]], radii=0.03))

    def update_dense_mesh(self, mesh, normals: np.ndarray | None = None):
        """Log the extracted TSDF isosurface (mapping/mesh.py
        TriangleMesh) under /world/dense/mesh. The (x,−z,−y) display
        remap has determinant −1, so faces are rewound (indices 1↔2)
        to keep normals outward; vertex normals get the same remap.
        Meshing is host-side and not cheap — call on demand (end of
        run / checkpoint), not at the keyframe cadence."""
        verts = _remap(np.asarray(mesh.vertices, np.float64))
        faces = np.asarray(mesh.faces)[:, [0, 2, 1]]
        self.last["dense_mesh"] = (verts, faces)
        if not self.enabled:
            return
        kw = {}
        if normals is not None:
            kw["vertex_normals"] = _remap(np.asarray(normals, np.float64))
        rr.log("/world/dense/mesh",
               rr.Mesh3D(vertex_positions=verts,
                         triangle_indices=faces, **kw))
