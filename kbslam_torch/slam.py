"""SLAM host shell: feed RGB-D frames, read back the trajectory.

Port of ``kbslam.slam.SLAM`` with its three BA modes:

- ``"on_keyframe"`` (the default): one local BA right after each keyframe
  insertion;
- ``"async"``: the solve runs on a snapshot while tracking goes on, and
  its result is merged into the live map once it is ready (at most one
  solve in flight);
- ``"disabled"``: visual odometry with the keyframe map.

On CUDA the asynchronous solve runs on a side stream. The snapshot is
cloned on the current stream, before the next step writes the live map
in place; the side stream waits for the clone, solves and records an
event. ``process`` polls that event (``Event.query``, which never
blocks) and merges on the current stream after ``wait_event``. Every
tensor that crosses between the streams gets ``record_stream``, so the
caching allocator does not hand its memory out while the other stream
may still use it. On the CPU (only when the caller names it) the solve
runs at dispatch and merges at the next poll.

Culling, loop closure, relocalization and dense mapping are later slices
of the port (ROADMAP.md) and raise ``NotImplementedError``.
"""
from __future__ import annotations

import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from kbslam_torch.ba.local_ba import BAStats, make_async_ba, make_local_ba
from kbslam_torch.ba.merge import merge_ba_result
from kbslam_torch.device import pick_device
from kbslam_torch.geom.camera import Intrinsics
from kbslam_torch.mapping.state import device_copy
from kbslam_torch.pipeline import init_state, make_track_step

_OUTPUT_FIELDS = ("pose_q", "pose_t", "success", "added_kf", "inlier_ratio",
                  "num_matches", "num_inliers", "num_features", "anchor_id",
                  "anchor_q", "anchor_t")


def pose_T(q, t) -> np.ndarray:
    """Host 4x4 SE(3) from a (w, x, y, z) quaternion + translation."""
    w, x, y, z = (float(v) for v in q)
    n = (w * w + x * x + y * y + z * z) or 1.0
    s2 = 2.0 / n
    T = np.eye(4)
    T[:3, :3] = [
        [1 - s2 * (y * y + z * z), s2 * (x * y - w * z), s2 * (x * z + w * y)],
        [s2 * (x * y + w * z), 1 - s2 * (x * x + z * z), s2 * (y * z - w * x)],
        [s2 * (x * z - w * y), s2 * (y * z + w * x), 1 - s2 * (x * x + y * y)],
    ]
    T[:3, 3] = np.asarray(t, dtype=np.float64)
    return T


def output_to_host(out) -> dict:
    """All TrackOutput fields in ONE device-to-host copy (float64 values;
    the integers are small and exact)."""
    flat = torch.cat([getattr(out, f).reshape(-1).to(torch.float64)
                      for f in _OUTPUT_FIELDS]).cpu().numpy()
    res, i = {}, 0
    for f in _OUTPUT_FIELDS:
        n = getattr(out, f).numel()
        res[f] = flat[i:i + n] if n > 1 else flat[i]
        i += n
    return res


def refine_frame_poses(frame_poses, frame_anchors, map_state) -> np.ndarray:
    """Each frame pose re-expressed against its anchor keyframe's current
    pose: T_i' = T_a(now) T_a(at tracking)^-1 T_i. Frames whose anchor
    left the ring keep their pose."""
    ids = map_state.kf_id.cpu().numpy()
    live = {int(k): i for i, k in enumerate(ids) if k >= 0}
    kf_q = map_state.kf_q.cpu().numpy()
    kf_t = map_state.kf_t.cpu().numpy()
    out = []
    for T, (aid, Ta) in zip(frame_poses, frame_anchors):
        if aid >= 0 and aid in live:
            s = live[aid]
            T = pose_T(kf_q[s], kf_t[s]) @ np.linalg.inv(Ta) @ T
        out.append(T)
    return np.stack(out) if out else np.zeros((0, 4, 4))


def map_keyframe_positions(m) -> np.ndarray:
    """Positions of the keyframes in the ring (Map::GetKeyFramesPositions)."""
    valid = m.kf_id.cpu().numpy() >= 0
    return m.kf_t.cpu().numpy()[valid]


def map_point_positions(m) -> np.ndarray:
    """Positions of the landmarks that keyframes still reference
    (Map::GetMapPointsPositions)."""
    mp = m.kf_mp.cpu().numpy()
    P = m.capacity_mp
    live = (mp >= 0) & (mp >= int(m.num_mp) - P)
    slots = np.unique(mp[live]) % P
    return m.mp_pos.cpu().numpy()[slots] if len(slots) else np.zeros((0, 3))


def _stats_vector(stats: BAStats) -> torch.Tensor:
    """The five BA stats as one float64 vector (one copy to the host)."""
    return torch.stack([x.to(torch.float64) for x in stats])


class _InFlight(NamedTuple):
    """An asynchronous solve: its snapshot and result, its stats in host
    memory, and the event recorded after it on the side stream (None on
    the CPU). The stats are valid once the event has completed."""
    snapshot: object
    result: object
    stats_host: torch.Tensor
    event: Optional[torch.cuda.Event]


class SLAM:
    """Stateful wrapper: feed RGB-D frames, read back trajectory and map."""

    def __init__(self, config, K: np.ndarray, ba_mode: str = "on_keyframe",
                 use_mask: bool = True, seed: int = 0, dist=None,
                 device: Optional[torch.device] = None):
        if ba_mode not in ("on_keyframe", "async", "disabled"):
            raise ValueError(f"unknown ba_mode {ba_mode!r}")
        for name, on in (("cull", config.cull.enabled),
                         ("loop", config.loop.enabled
                          or config.loop.reloc_after > 0),
                         ("dense", config.dense.enabled),
                         ("dense_icp", config.dense_icp.mode != "off")):
            if on:
                raise NotImplementedError(
                    f"config.{name} is not ported yet (ROADMAP.md)")
        self.config = config
        self.device = pick_device(device)
        self.intr = Intrinsics.from_matrix(K, dist=dist)
        self.ba_mode = ba_mode
        self.use_mask = use_mask
        self._step = make_track_step(config, self.intr, use_mask=use_mask,
                                     seed=seed)
        self._ba = make_local_ba(config.ba, self.intr)
        self._ba_async = make_async_ba(config.ba, self.intr)
        self._ba_stream = (torch.cuda.Stream(self.device)
                           if ba_mode == "async" and self.device.type == "cuda"
                           else None)
        self._ba_inflight: Optional[_InFlight] = None
        self.state = init_state(config, self.device)
        self._ones_mask = None
        self._frame = 0
        self.trajectory: List[np.ndarray] = []   # poses of successes
        self.frame_poses: List[np.ndarray] = []  # per input frame
        self.frame_anchors: List[tuple] = []     # (anchor kf id, T_anchor)
        self.diagnostics: List[dict] = []
        self.ba_stats: List[dict] = []

    def _record_ba_stats(self, v: np.ndarray, wall_ms=None):
        self.ba_stats.append(dict(
            initial_cost=float(v[0]), final_cost=float(v[1]),
            iterations=int(v[2]), accepted=int(v[3]), num_pruned=int(v[4]),
            wall_ms=wall_ms))

    def _upload(self, rgb, depth, mask):
        dev = self.device
        rgb_t = torch.as_tensor(np.asarray(rgb, np.uint8)).to(dev)
        # torch's uint16 support is thin: widen depth to int32 on upload
        depth_t = torch.as_tensor(np.asarray(depth).astype(np.int32)).to(dev)
        mask_t = None
        if self.use_mask:
            if mask is not None:
                mask_t = torch.as_tensor(np.asarray(mask)).to(dev)
            else:
                if (self._ones_mask is None
                        or tuple(self._ones_mask.shape) != rgb_t.shape[:2]):
                    self._ones_mask = torch.ones(rgb_t.shape[:2],
                                                 dtype=torch.uint8, device=dev)
                mask_t = self._ones_mask
        return rgb_t, depth_t, mask_t

    def process(self, rgb, depth, mask=None) -> dict:
        """Track one frame (rgb [H, W, 3] uint8, depth [H, W] uint16)."""
        args = self._upload(rgb, depth, mask)
        t0 = time.perf_counter()
        self.state, out = self._step(self.state, *args)
        o = output_to_host(out)
        added_kf = bool(o["added_kf"])

        ran_ba = False
        if self.ba_mode == "on_keyframe" and added_kf:
            tb = time.perf_counter()
            new_map, stats = self._ba(self.state.map)
            self.state = self.state._replace(map=new_map)
            v = _stats_vector(stats).cpu().numpy()
            self._record_ba_stats(v, wall_ms=(time.perf_counter() - tb) * 1e3)
            ran_ba = True
        elif self.ba_mode == "async":
            # merge a finished solve first; a new one is dispatched last,
            # on the map as this frame leaves it
            ran_ba = self._async_ba_merge()
            if added_kf and self._ba_inflight is None:
                self._async_ba_dispatch()

        T = pose_T(o["pose_q"], o["pose_t"])
        if bool(o["success"]) or self._frame == 0:
            self.trajectory.append(T)
        self.frame_poses.append(T)
        self.frame_anchors.append((int(o["anchor_id"]),
                                   pose_T(o["anchor_q"], o["anchor_t"])))
        diag = dict(
            frame=self._frame,
            success=bool(o["success"]),
            added_kf=added_kf,
            ran_ba=ran_ba,
            inlier_ratio=float(o["inlier_ratio"]),
            num_matches=int(o["num_matches"]),
            num_inliers=int(o["num_inliers"]),
            num_features=int(o["num_features"]),
            wall_ms=(time.perf_counter() - t0) * 1e3,
        )
        self.diagnostics.append(diag)
        self._frame += 1
        return diag

    def _async_ba_dispatch(self):
        """Snapshot the live map and start a solve on it."""
        side = self._ba_stream
        if side is None:
            snap, result, stats = self._ba_async(self.state.map)
            self._ba_inflight = _InFlight(snap, result, _stats_vector(stats),
                                          None)
            return
        snap = device_copy(self.state.map)       # on the current stream
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            result, stats = self._ba(snap)
            stats_host = torch.empty(len(stats), dtype=torch.float64,
                                     pin_memory=True)
            stats_host.copy_(_stats_vector(stats), non_blocking=True)
            event = torch.cuda.Event()
            event.record(side)
        for t in snap:
            t.record_stream(side)
        self._ba_inflight = _InFlight(snap, result, stats_host, event)

    def _merge_inflight(self):
        f = self._ba_inflight
        if f.event is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(f.event)
            for t in f.result:
                t.record_stream(cur)
        self.state = self.state._replace(map=merge_ba_result(
            self.state.map, f.snapshot, f.result, self.config.ba))
        self._record_ba_stats(f.stats_host.numpy())
        self._ba_inflight = None

    def _async_ba_merge(self) -> bool:
        """Merge the solve in flight if it has finished; never waits."""
        f = self._ba_inflight
        if f is None or (f.event is not None and not f.event.query()):
            return False
        self._merge_inflight()
        return True

    def finish(self):
        """Wait for the solve in flight, if any, and merge it."""
        if self._ba_inflight is not None:
            if self._ba_inflight.event is not None:
                self._ba_inflight.event.synchronize()
            self._merge_inflight()

    def refined_trajectory(self) -> np.ndarray:
        """Frame poses re-expressed against the BA-refined keyframes
        (``refine_frame_poses``); online poses never see the refinement,
        because each chained off the newest keyframe, the BA gauge."""
        return refine_frame_poses(self.frame_poses, self.frame_anchors,
                                  self.state.map)

    def keyframe_positions(self) -> np.ndarray:
        return map_keyframe_positions(self.state.map)

    def map_points(self) -> np.ndarray:
        return map_point_positions(self.state.map)

    @property
    def num_keyframes(self) -> int:
        return int(self.state.map.num_kf)
