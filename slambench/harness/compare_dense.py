"""The dense model's numbers, program against reference, frame by frame:
the ICP refine of a frame's pose against the submap atlas, and a
keyframe's fusion into its submap (``drivers/replay.py``).

The driver copies, at the start of each checked stretch, the atlas
slots the stretch reads or writes (the active submap and the ICP
window's), and after each keyframe frame the active slot again; the
reference then runs each frame from the program's state before it
(``harness/compare.py``'s step and local BA, then the ICP and the
fusion of ``slambench/reference/mapping``) and is held to what the
program returned and to the slot it left.

``DenseGaps`` collects:

- ``icp_mm``, ``icp_mdeg``: the widest gap of a frame's returned pose,
  over the frames where either side ran the ICP (the returned pose is
  the refined one where the refine was accepted, else the step's);
- ``icp_valid_pct``: the widest relative gap of the ICP's live points
  (``num_valid``), where both ran it;
- ``icp_decisions``: frames where one side ran the ICP and the other did
  not, or where the two accepted differently;
- ``tsdf_gap``: the widest |tsdf| gap (in units of the truncation) of
  the fused slot, over the voxels the rounding-edge rule keeps: seen
  from the program's fusion pose and from the reference's, the voxel's
  projection lies ``EDGE_PX`` or more from a rounding edge in u and v,
  both round to the same pixel, and both observe the voxel or neither
  does (``chip_smoke.py`` phase 16's rule, for two poses);
- ``weight_pct``: of the voxels either side's fusion changed, the share
  whose weights differ (every voxel counts).
"""
from __future__ import annotations

import numpy as np
import torch

from slambench.harness.compare import quat_matrix, rot_gap_deg
from slambench.reference.mapping import dense

EDGE_PX = 1e-3      # nearer a rounding edge, a voxel may read either pixel


def copy_slot(atlas, slot: int):
    """A copy of ring slot ``slot``'s (tsdf, weight), on the current
    stream (no host sync)."""
    return (atlas.tsdf[slot].clone(), atlas.weight[slot].clone())


def copy_meta(atlas):
    """A copy of the atlas's bookkeeping: (count, anchor_q, anchor_t,
    anchor_kf_id)."""
    return (atlas.count, atlas.anchor_q.clone(), atlas.anchor_t.clone(),
            atlas.anchor_kf_id.clone())


class DenseGaps:
    """Running gaps of the dense model over the checked frames (see the
    module docstring)."""

    def __init__(self):
        self.widest = {k: 0.0 for k in ("icp_mm", "icp_mdeg",
                                        "icp_valid_pct", "tsdf_gap")}
        self.icp_frames = 0
        self.fusions = 0
        self.icp_decisions = 0
        self.weights = [0, 0]       # differing, changed

    def _widen(self, key, v):
        self.widest[key] = max(self.widest[key], float(v))

    def icp(self, prog: dict, ref: dict):
        """One frame's ICP. Each side: ``ran``, ``accepted``, ``n`` (live
        points, when it ran) and its returned pose ``R`` 3x3, ``t`` [3]
        (metres)."""
        if not (prog["ran"] or ref["ran"]):
            return
        self.icp_frames += 1
        if prog["ran"] != ref["ran"] or prog["accepted"] != ref["accepted"]:
            self.icp_decisions += 1
        if prog["ran"] and ref["ran"]:
            self._widen("icp_valid_pct", abs(prog["n"] - ref["n"])
                        / max(ref["n"], 1) * 100)
        self._widen("icp_mm", np.linalg.norm(np.asarray(prog["t"])
                                             - np.asarray(ref["t"])) * 1e3)
        self._widen("icp_mdeg", rot_gap_deg(prog["R"], ref["R"]) * 1e3)

    def fusion(self, before, prog_after, ref_after, keep_of, slab: int):
        """One keyframe's fusion into one slot: ``before``, ``prog_after``
        and ``ref_after`` its (tsdf, weight) before and after each side's
        fusion; ``keep_of(x0, nx)`` the rounding-edge rule's [V] mask of
        the x rows [x0, x0 + nx), compared ``slab`` rows at a time."""
        self.fusions += 1
        nx = before[0].shape[0]
        for x in range(0, nx, slab):
            sl = slice(x, x + slab)
            w0, wp, wr = (v[1][sl].reshape(-1)
                          for v in (before, prog_after, ref_after))
            changed = (wp != w0) | (wr != w0)
            self.weights[0] += int((changed & (wp != wr)).sum())
            self.weights[1] += int(changed.sum())
            keep = keep_of(x, min(slab, nx - x))
            gap = (prog_after[0][sl].reshape(-1)
                   - ref_after[0][sl].reshape(-1)).abs()
            if bool(keep.any()):
                self._widen("tsdf_gap", gap[keep].max())

    def numbers(self) -> dict:
        out = dict(self.widest)
        out["icp_decisions"] = float(self.icp_decisions)
        out["weight_pct"] = 100.0 * self.weights[0] / max(self.weights[1], 1)
        return out


def keep_rule(cfg, intr, depth_m, local_a, local_b):
    """``keep_of(x0, nx)``: the voxels of the rows [x0, x0 + nx) that the
    rounding-edge rule keeps between the fusion poses ``local_a`` and
    ``local_b`` (camera to submap, ``SE3``) over the metric depth image
    ``depth_m`` [H, W]."""
    H, W = depth_m.shape

    def seen(pose, x0, nx):
        u, v, z, inside = dense.projection(cfg, intr, pose, x0, nx, W, H)
        ui = torch.round(u).clamp(-1, W).to(torch.int64)
        vi = torch.round(v).clamp(-1, H).to(torch.int64)
        flat = vi.clamp(0, H - 1) * W + ui.clamp(0, W - 1)
        d = torch.nan_to_num(depth_m.reshape(-1)[flat], nan=0.0)
        observed = (inside & (d > cfg.min_depth) & (d < cfg.max_depth)
                    & (d - z > -cfg.truncation))
        clear = (_edge_dist(u) >= EDGE_PX) & (_edge_dist(v) >= EDGE_PX)
        return ui, vi, observed, clear

    def keep_of(x0, nx):
        ua, va, oa, ca = seen(local_a, x0, nx)
        ub, vb, ob, cb = seen(local_b, x0, nx)
        return ca & cb & (ua == ub) & (va == vb) & (oa == ob)
    return keep_of


def _edge_dist(x: torch.Tensor) -> torch.Tensor:
    """Distance of ``x`` from the nearest .5, where rounding switches."""
    return (x - torch.floor(x) - 0.5).abs()


def pose_answer(q, t) -> dict:
    """``R`` and ``t`` of a pose given as a quaternion and a translation
    (tensors or arrays)."""
    q = np.asarray(q.cpu() if torch.is_tensor(q) else q, np.float64)
    t = np.asarray(t.cpu() if torch.is_tensor(t) else t, np.float64)
    return dict(R=quat_matrix(q), t=t)
