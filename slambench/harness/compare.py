"""Program against reference, frame by frame.

The reference (``slambench/reference``, a frozen eager copy of the
port's step and local BA, with the describe kernel's plain twin) starts
from the program's own state before a frame, which the driver copied
during the window, runs the same frame, and is held against what the
program returned for that frame and the state it left. So every frame
is judged on its own: a difference does not carry into the next.

``Gaps`` collects, over the checked frames:

- ``pose_mm``, ``rot_mdeg``: the widest gap of the frame's pose,
  ``pose_med_mm`` the median gap, and ``pose_stream_med_mm`` the largest
  of the streams' own median gaps (a fault in one stream of a batch);
- ``inliers_pct``: the widest relative gap of the PnP inlier count;
- ``kp_pct``, ``desc_pct``: the share of an inserted keyframe's
  keypoints that differ (position or validity), and of descriptor rows
  among keypoints both hold (the describe kernel against its twin);
- ``map_mm``, ``map_mdeg``: the widest gap of a live keyframe's
  position and rotation in the ring after the frame (its insertion and,
  where the cell solves, the BA);
- ``mp_mm``: the widest gap between the landmarks the two maps reference
  from one keypoint (held alike by both) of one live keyframe: the
  landmarks a frame made, and those its solve moved;
- ``mp_pct``: of the landmark references in the rows an insertion writes
  (the new keyframe's and the previous one's), the share that only one
  map holds or whose landmarks lie more than ``MP_TOL_MM`` apart;
- ``ba_cost_pct``: the widest relative gap of a solve's final cost;
- ``decisions``: frames where success, the keyframe decision or the
  ring's keyframe and landmark counts differ.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

MP_TOL_MM = 0.1     # landmarks further apart count as differing (mp_pct)


def quat_matrix(q) -> np.ndarray:
    w, x, y, z = (float(v) for v in q)
    n = (w * w + x * x + y * y + z * z) or 1.0
    s = 2.0 / n
    return np.array([
        [1 - s * (y * y + z * z), s * (x * y - w * z), s * (x * z + w * y)],
        [s * (x * y + w * z), 1 - s * (x * x + z * z), s * (y * z - w * x)],
        [s * (x * z - w * y), s * (y * z + w * x), 1 - s * (x * x + y * y)]])


def rot_gap_deg(Ra: np.ndarray, Rb: np.ndarray) -> float:
    """The angle between two rotations, from ||Ra - Rb||_F = 2 sqrt(2)
    sin(angle / 2) (exact near zero, where acos of the trace is not)."""
    d = np.linalg.norm(np.asarray(Ra) - np.asarray(Rb)) / (2 * math.sqrt(2))
    return math.degrees(2 * math.asin(min(1.0, d)))


def quat_gap_deg(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """[...] angles between the rotations of quaternions [..., 4], from
    ||qa - qb|| = 2 sin(angle / 4) for unit quaternions of one sign
    (exact near zero, where acos of their product is not)."""
    qa = qa.double() / qa.double().norm(dim=-1, keepdim=True)
    qb = qb.double() / qb.double().norm(dim=-1, keepdim=True)
    sign = torch.where((qa * qb).sum(-1, keepdim=True) < 0, -1.0, 1.0)
    half = ((qa - sign * qb).norm(dim=-1) / 2).clamp(max=1.0)
    return torch.rad2deg(4 * torch.asin(half))


def _referenced(m):
    """[M, F, 3] positions of the landmarks each keyframe keypoint
    references, and [M, F] whether it references a live, valid one."""
    P = m.mp_pos.shape[0]
    ids = m.kf_mp.long()
    live = (ids >= 0) & (ids >= m.num_mp.long() - P)
    slot = torch.remainder(ids, P)
    return m.mp_pos[slot], live & m.mp_valid[slot]


class Gaps:
    """Running gaps over the checked frames (see the module docstring)."""

    def __init__(self):
        self.frames = 0
        self.solves = 0
        self.widest = {k: 0.0 for k in ("pose_mm", "rot_mdeg", "inliers_pct",
                                        "map_mm", "map_mdeg", "mp_mm",
                                        "ba_cost_pct")}
        self.pose = {}          # every frame's pose gap, mm, by stream
        self.kp = [0, 0]        # differing, compared
        self.desc = [0, 0]
        self.mp = [0, 0]
        self.decisions = 0

    def _widen(self, key, v):
        self.widest[key] = max(self.widest[key], float(v))

    def frame(self, prog: dict, ref_out, prog_after, ref_after,
              prog_cost: Optional[float] = None,
              ref_cost: Optional[float] = None, stream: int = 0):
        """One checked frame: its answer, the maps after it and, when it
        solved, the solve. ``prog``: the program's answer (``R`` 3x3,
        ``t`` [3], ``success``, ``added_kf``, ``num_inliers``);
        ``ref_out``: the reference's ``TrackOutput``; ``prog_after`` and
        ``ref_after``: the two maps after the frame (``MapState`` fields
        in the same order); the costs: the frame's solve, if it ran;
        ``stream``: the frame's stream in a batch."""
        self.answer(prog, ref_out, stream)
        self.maps(prog_after, ref_after,
                  bool(ref_out.added_kf) and bool(prog["added_kf"]))
        if prog_cost is not None or ref_cost is not None:
            self.solve(prog_cost, ref_cost)

    def answer(self, prog: dict, ref_out, stream: int = 0):
        """One frame's answer against the reference's ``TrackOutput``."""
        self.frames += 1
        r_t = ref_out.pose_t.double().cpu().numpy()
        r_R = quat_matrix(ref_out.pose_q.cpu().numpy())
        gap = float(np.linalg.norm(np.asarray(prog["t"]) - r_t)) * 1e3
        self.pose.setdefault(stream, []).append(gap)
        self._widen("pose_mm", gap)
        self._widen("rot_mdeg", rot_gap_deg(np.asarray(prog["R"]), r_R) * 1e3)
        n_r = int(ref_out.num_inliers)
        self._widen("inliers_pct",
                    abs(int(prog["num_inliers"]) - n_r) / max(n_r, 1) * 100)
        self.decisions += int(bool(prog["success"]) != bool(ref_out.success)
                              or bool(prog["added_kf"]) != bool(ref_out.added_kf))

    def maps(self, pm, rm, inserted: bool):
        """The program's map against the reference's; ``inserted``: both
        inserted a keyframe since the last comparison (its keypoints and
        descriptors, and the landmark references it wrote, are
        compared)."""
        if int(pm.num_kf) != int(rm.num_kf) or int(pm.num_mp) != int(rm.num_mp):
            self.decisions += 1
        live = (rm.kf_id >= 0) & (pm.kf_id >= 0)
        if bool(live.any()):
            d = (pm.kf_t - rm.kf_t)[live].double().norm(dim=-1).max()
            self._widen("map_mm", float(d) * 1e3)
            self._widen("map_mdeg",
                        float(quat_gap_deg(pm.kf_q[live], rm.kf_q[live]).max())
                        * 1e3)
        same = (pm.kf_kp_valid & rm.kf_kp_valid & live[:, None]
                & ((pm.kf_kp_xy - rm.kf_kp_xy).abs().amax(-1) <= 1e-3))
        p_pos, p_live = _referenced(pm)
        r_pos, r_live = _referenced(rm)
        gap = (p_pos - r_pos).double().norm(dim=-1) * 1e3      # [M, F] mm
        both = same & p_live & r_live
        if bool(both.any()):
            self._widen("mp_mm", float(gap[both].max()))
        if inserted:
            s = (int(rm.num_kf) - 1) % rm.kf_id.shape[0]
            written = [s, (s - 1) % rm.kf_id.shape[0]]
            held = (same & (p_live | r_live))[written]
            differ = held & ((p_live != r_live) | (gap > MP_TOL_MM))[written]
            self.mp[0] += int(differ.sum())
            self.mp[1] += int(held.sum())
            pv, rv = pm.kf_kp_valid[s], rm.kf_kp_valid[s]
            moved = (pm.kf_kp_xy[s] - rm.kf_kp_xy[s]).abs().amax(-1) > 1e-3
            either = pv | rv
            self.kp[0] += int(((pv != rv) | (moved & either)).sum())
            self.kp[1] += int(either.sum())
            both = pv & rv & ~moved
            rows = (pm.kf_desc[s] != rm.kf_desc[s]).any(-1) & both
            self.desc[0] += int(rows.sum())
            self.desc[1] += int(both.sum())

    def solve(self, prog_cost: Optional[float], ref_cost: Optional[float]):
        """One solve's final cost against the reference's; a solve that
        only one side ran is a decision apart."""
        self.solves += 1
        if prog_cost is None or ref_cost is None:
            self.decisions += 1
        else:
            self._widen("ba_cost_pct", abs(prog_cost - ref_cost)
                        / max(abs(ref_cost), 1e-12) * 100)

    def numbers(self) -> dict:
        out = dict(self.widest)
        every = [g for gaps in self.pose.values() for g in gaps]
        out["pose_med_mm"] = float(np.median(every)) if every else 0.0
        out["pose_stream_med_mm"] = max(
            (float(np.median(g)) for g in self.pose.values()), default=0.0)
        out["kp_pct"] = 100.0 * self.kp[0] / max(self.kp[1], 1)
        out["desc_pct"] = 100.0 * self.desc[0] / max(self.desc[1], 1)
        out["mp_pct"] = 100.0 * self.mp[0] / max(self.mp[1], 1)
        out["decisions"] = float(self.decisions)
        return out


def to_reference(ref_pipeline, state):
    """A copy of the program's ``TrackState`` as the reference's."""
    from slambench.reference.mapping.state import MapState

    return ref_pipeline.TrackState(
        MapState(*(t.clone() for t in state.map)),
        *(t.clone() for t in state[1:]))


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: (value, limit)}) over the numbers the cell's
    traffic file gives a limit; a number that is not finite fails."""
    check = {k: (numbers[k], float(lim)) for k, lim in limits.items()}
    ok = all(math.isfinite(v) and v <= lim for v, lim in check.values())
    return ok, check


def snapshot_into(dst, src):
    """Copy the state ``src`` into the preallocated ``dst`` on the
    current stream (no allocation, no host sync)."""
    for d, s in zip(_leaves(dst), _leaves(src)):
        d.copy_(s, non_blocking=True)
    return dst


def empty_like_state(state):
    return type(state)(type(state.map)(*(torch.empty_like(t) for t in state.map)),
                       *(torch.empty_like(t) for t in state[1:]))


def _leaves(state):
    yield from state.map
    yield from state[1:]
