"""SLAM host shell: feed RGB-D frames, read back the trajectory.

Port of ``kbslam.slam.SLAM`` with its three BA modes:

- ``"on_keyframe"`` (the default): one local BA right after each keyframe
  insertion;
- ``"async"``: the solve runs on a snapshot while tracking goes on, and
  its result is merged into the live map once it is ready (at most one
  solve in flight);
- ``"disabled"``: visual odometry with the keyframe map.

The asynchronous solve is ``ba.local_ba.AsyncLocalBA``: on CUDA the
snapshot is copied into the static input of a captured local-BA graph
on the current stream, before the next step writes the live map in
place, and the graph replays on a side stream, followed by an event.
``process`` polls that event (``Event.query``, which never blocks) and
merges on the current stream after ``wait_event``. On the CPU (only
when the caller names it) the solve runs at dispatch and merges at the
next poll.

Keyframe culling (``config.cull``), loop closure (``config.loop.enabled``)
and relocalization (``config.loop.reloc_after``) run in the reference's
order inside ``process``: cull on insertion, then BA (or the merge of a
finished asynchronous solve), the relocalization tick, dense fusion of a
keyframe's depth (``config.dense.enabled``, the monolithic TSDF volume of
``mapping/dense.py``), the loop tick, and the asynchronous dispatch last,
so a new solve sees the corrected map. The submap atlas
(``dense.submap_every > 0``) and dense ICP belong to Slice E2 of the port
(ROADMAP.md) and raise ``NotImplementedError``.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from kbslam_torch.ba.local_ba import (AsyncLocalBA, make_local_ba,
                                      stats_record, stats_vector)
from kbslam_torch.convert import tsdf_to_numpy
from kbslam_torch.device import pick_device, upload
from kbslam_torch.geom.camera import Intrinsics
from kbslam_torch.loop.reloc import make_reloc_step
from kbslam_torch.loop.runner import LoopCloser
from kbslam_torch.mapping import dense, mesh, raycast
from kbslam_torch.mapping.cull import make_cull
from kbslam_torch.pipeline import init_state, make_track_step

_OUTPUT_FIELDS = ("pose_q", "pose_t", "success", "added_kf", "inlier_ratio",
                  "num_matches", "num_inliers", "num_features", "anchor_id",
                  "anchor_q", "anchor_t")
_FIELD_WIDTH = {f: 4 if f.endswith("_q") else 3 if f.endswith("_t") else 1
                for f in _OUTPUT_FIELDS}
OUTPUT_WIDTH = sum(_FIELD_WIDTH.values())    # a row of output_rows


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


def output_rows(out) -> torch.Tensor:
    """TrackOutputs stacked over a leading frame axis [n, ...] -> one
    [n, OUTPUT_WIDTH] float64 tensor on their device, a row per frame
    (the integers are small and exact in float64)."""
    n = out.pose_q.shape[0]
    return torch.cat([getattr(out, f).reshape(n, -1).to(torch.float64)
                      for f in _OUTPUT_FIELDS], dim=1)


def row_to_fields(row: np.ndarray) -> dict:
    """One row of ``output_rows``, read back on the host, as a dict of
    the TrackOutput fields (vectors as arrays, scalars as floats)."""
    res, i = {}, 0
    for f in _OUTPUT_FIELDS:
        n = _FIELD_WIDTH[f]
        res[f] = row[i:i + n] if n > 1 else row[i]
        i += n
    return res


def output_to_host(out) -> dict:
    """All TrackOutput fields of one frame in ONE device-to-host copy."""
    stacked = type(out)(*(f[None] for f in out))
    return row_to_fields(output_rows(stacked)[0].cpu().numpy())


def reloc_to_host(r, m) -> dict:
    """A relocalization attempt's result (``loop.reloc.RelocResult``) and
    the map after it, in one device-to-host copy: success, the matched
    keyframe's id, score, inliers, the map's insertion count and the
    recovered pose."""
    slot = r.slot.reshape(1).to(torch.int64)
    v = torch.cat([torch.stack([
        r.success.to(torch.float64),
        m.kf_id.index_select(0, slot)[0].to(torch.float64),
        r.score.to(torch.float64), r.num_inliers.to(torch.float64),
        m.num_kf.to(torch.float64)]),
        r.pose_q.to(torch.float64), r.pose_t.to(torch.float64)]).cpu().numpy()
    return dict(success=bool(v[0]), matched_id=int(v[1]), score=float(v[2]),
                inliers=int(v[3]), num_kf=int(v[4]), pose_q=v[5:9],
                pose_t=v[9:12])


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


def check_dense_config(config):
    """Raise on the dense options of later slices: the submap atlas and
    dense ICP (Slice E2)."""
    for name, on in (("dense.submap_every", config.dense.submap_every > 0),
                     ("dense_icp", config.dense_icp.mode != "off")):
        if on:
            raise NotImplementedError(
                f"config.{name} belongs to Slice E2 of the port (ROADMAP.md)")


class DenseViews:
    """The read side of the monolithic TSDF volume, shared by ``SLAM``
    and ``streaming.ChunkedStream``. The shell sets ``tsdf`` (the
    volume, or None with dense mapping off), ``dense_cfg``, ``intr``,
    ``_image_hw``, ``_depth_scale`` and ``_last_kf_view`` (pose and host
    depth of the newest fused keyframe)."""

    def dense_surface(self) -> tuple:
        """Zero-crossing point cloud of the volume: (points [M, 3] world,
        |tsdf| residual [M]) (``mapping/dense.surface_points``)."""
        if self.tsdf is None:
            raise RuntimeError("dense mapping disabled "
                               "(SLAMConfig.dense.enabled)")
        return dense.surface_points(self.tsdf, self.dense_cfg)

    def dense_mesh(self) -> mesh.TriangleMesh:
        """The volume's zero isosurface as one welded triangle mesh
        (``mapping/mesh.marching_tetrahedra``, host-side)."""
        if self.tsdf is None:
            raise RuntimeError("dense mapping disabled "
                               "(SLAMConfig.dense.enabled)")
        return mesh.marching_tetrahedra(tsdf_to_numpy(self.tsdf),
                                        self.dense_cfg)

    def _scaled_intr(self, stride: int):
        """(intrinsics, height, width) of a render at every stride-th
        pixel: pixel i of the small image is full-size pixel i*stride, so
        (i*s - cx)/fx == (i - cx/s)/(fx/s) exactly; the distortion
        coefficients act on normalized coordinates and stay."""
        H, W = self._image_hw
        if stride == 1:
            return self.intr, H, W
        i = self.intr
        return (Intrinsics(i.fx / stride, i.fy / stride, i.cx / stride,
                           i.cy / stride, i.dist), H // stride, W // stride)

    def render_view(self, q=None, t=None, stride: int = 1):
        """Raycast the volume from camera-to-world (q, t), by default the
        newest fused keyframe's pose: a ``RaycastResult`` with world
        normals on the volume's device, or None before the first fused
        keyframe. Give both of q and t or neither. ``stride`` renders
        every stride-th pixel (the full 640x480 render marches 20M
        samples).

        The monolithic volume is never re-warped by a loop correction,
        so the pose a keyframe was fused at, which the default keeps, is
        the pose to render it from; a re-posed model (the submap atlas)
        would need the keyframe's current ring pose instead."""
        if (q is None) != (t is None):
            raise ValueError("render_view takes both q and t, or neither")
        if q is None:
            if self._last_kf_view is None:
                return None
            q, t, _ = self._last_kf_view
        vol, pose, _ = raycast.resolve_render_model(self.tsdf, None, None,
                                                    q, t)
        if vol is None:
            return None
        intr_s, H, W = self._scaled_intr(stride)
        return raycast.make_raycast(self.dense_cfg, intr_s, H, W)(
            vol, pose.q, pose.t)

    def map_consistency(self, stride: int = 2) -> Optional[dict]:
        """Rendered against observed depth at the newest fused keyframe
        (``mapping/raycast.render_consistency``): median and p90 error
        and coverage, or None before the first fused keyframe."""
        if self._last_kf_view is None:
            return None
        q, t, depth = self._last_kf_view
        vol, pose, _ = raycast.resolve_render_model(self.tsdf, None, None,
                                                    q, t)
        if vol is None:
            return None
        intr_s, H, W = self._scaled_intr(stride)
        depth_m = (np.asarray(depth, np.float32)[::stride, ::stride]
                   * self._depth_scale)[:H, :W]
        return raycast.render_consistency(vol, pose, depth_m, intr_s,
                                          self.dense_cfg)


class SLAM(DenseViews):
    """Stateful wrapper: feed RGB-D frames, read back trajectory and map."""

    def __init__(self, config, K: np.ndarray, ba_mode: str = "on_keyframe",
                 use_mask: bool = True, seed: int = 0, dist=None,
                 device: Optional[torch.device] = None):
        if ba_mode not in ("on_keyframe", "async", "disabled"):
            raise ValueError(f"unknown ba_mode {ba_mode!r}")
        check_dense_config(config)
        self.config = config
        self.device = pick_device(device)
        self.intr = Intrinsics.from_matrix(K, dist=dist)
        self.ba_mode = ba_mode
        self.use_mask = use_mask
        self._step = make_track_step(config, self.intr, use_mask=use_mask,
                                     seed=seed)
        self._ba = make_local_ba(config.ba, self.intr)
        self._async = (AsyncLocalBA(config.ba, self.intr)
                       if ba_mode == "async" else None)
        self._cull = make_cull(config.cull) if config.cull.enabled else None
        lc = config.loop
        self._loop = (LoopCloser(config, self.intr) if lc.enabled else None)
        self._reloc = (make_reloc_step(
            config, self.intr, use_mask=use_mask, word_bits=lc.word_bits,
            score_min=lc.reloc_score_min, min_inliers=lc.reloc_min_inliers,
            seed=seed) if lc.reloc_after > 0 else None)
        self._fail_streak = 0
        # keyframes from this id on were inserted while tracking failed
        # (at held poses): relocalization does not match them
        self._tracked_kf = 0
        # the runner's event list itself
        self.loop_events: List[dict] = (
            self._loop.events if self._loop is not None else [])
        self.reloc_events: List[dict] = []
        self._state = init_state(config, self.device)
        self._ones_mask = None
        self._pinned = None   # ([(shape, dtype)], pinned host buffers)
        self._frame = 0
        self.trajectory: List[np.ndarray] = []   # poses of successes
        self.frame_poses: List[np.ndarray] = []  # per input frame
        self.frame_anchors: List[tuple] = []     # (anchor kf id, T_anchor)
        self.diagnostics: List[dict] = []
        self.ba_stats: List[dict] = []
        self.dense_cfg = config.dense
        self._image_hw = (config.image_height, config.image_width)
        self._depth_scale = config.map.depth_scale
        self._last_kf_view = None
        self.tsdf, self._integrate = None, None
        if config.dense.enabled:
            self.tsdf = dense.empty_tsdf(config.dense, self.device)
            self._integrate = dense.make_integrate(
                config.dense, self.intr, config.map.depth_scale)

    @property
    def state(self):
        return self._state

    @state.setter
    def state(self, value):
        """Replace the tracking state (a resume): the loop runner counts
        its ordinals on from the new map's insertions."""
        self._state = value
        self._tracked_kf = int(value.map.num_kf)
        if self._loop is not None:
            self._loop.start_at(self._tracked_kf)

    def _upload(self, rgb, depth, mask):
        """The frame on the device. On CUDA it goes through pinned host
        buffers with asynchronous copies, so the upload makes no host
        sync; the buffers are reused on the next frame, after this
        frame's output copy has waited for the stream."""
        dev = self.device
        # torch's uint16 support is thin: widen depth to int32 on upload
        frame = [np.asarray(rgb, np.uint8), np.asarray(depth, np.int32)]
        if self.use_mask and mask is not None:
            frame.append(np.asarray(mask))
        if dev.type == "cpu":
            tensors = [torch.from_numpy(np.array(a)) for a in frame]
        else:
            key = [(a.shape, a.dtype) for a in frame]
            if self._pinned is None or self._pinned[0] != key:
                self._pinned = (key, [torch.from_numpy(np.empty(s, d))
                                      .pin_memory() for s, d in key])
            tensors = []
            for a, buf in zip(frame, self._pinned[1]):
                np.copyto(buf.numpy(), a)
                tensors.append(buf.to(dev, non_blocking=True))
        rgb_t, depth_t = tensors[:2]
        mask_t = None
        if self.use_mask:
            if mask is not None:
                mask_t = tensors[2]
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
        self._state, out = self._step(self._state, *args)
        o = output_to_host(out)

        if self._cull is not None and o["added_kf"]:
            self._state = self._state._replace(
                map=self._cull(self._state.map))

        ran_ba = False
        if self.ba_mode == "on_keyframe" and o["added_kf"]:
            tb = time.perf_counter()
            new_map, stats = self._ba(self._state.map)
            self._state = self._state._replace(map=new_map)
            v = stats_vector(stats).cpu().numpy()
            self.ba_stats.append(stats_record(
                v, wall_ms=(time.perf_counter() - tb) * 1e3))
            ran_ba = True
        elif self.ba_mode == "async":
            # merge a finished solve first, so the probes below see a
            # quiet pipe; a new one is dispatched last
            ran_ba = self._async.ready()
            if ran_ba:
                self._merge_inflight()

        # a failed frame may insert by the policy and again by
        # relocalization: the runner hears of both
        inserted = int(bool(o["added_kf"]))
        if self._reloc is not None:
            o = self._reloc_tick(o, args)
            inserted += int(o.get("relocalized", False))

        # dense fusion after the reloc tick (a relocalized frame is a
        # keyframe at its recovered pose) and before the loop tick
        if self._integrate is not None and o["added_kf"]:
            dev = self.device
            self.tsdf = self._integrate(
                self.tsdf, args[1],
                upload(np.asarray(o["pose_q"], np.float32), dev),
                upload(np.asarray(o["pose_t"], np.float32), dev))
            self._last_kf_view = (np.asarray(o["pose_q"]),
                                  np.asarray(o["pose_t"]), depth)

        inflight = self._async.inflight if self._async is not None else None
        if self._loop is not None:
            if inserted:
                self._loop.note_insertions(inserted)
            self._state = self._loop.tick(self._state, self._frame, inflight)

        if (self.ba_mode == "async" and o["added_kf"]
                and self._async.inflight is None):
            self._async.dispatch(self._state.map)

        T = pose_T(o["pose_q"], o["pose_t"])
        if bool(o["success"]) or self._frame == 0:
            self.trajectory.append(T)
        self.frame_poses.append(T)
        self.frame_anchors.append((int(o["anchor_id"]),
                                   pose_T(o["anchor_q"], o["anchor_t"])))
        diag = dict(
            frame=self._frame,
            success=bool(o["success"]),
            added_kf=bool(o["added_kf"]),
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

    def _reloc_tick(self, o, frame_args) -> dict:
        """After ``reloc_after`` failures in a row, try to re-anchor by
        place recognition (loop/reloc.py). On success the frame is a new
        keyframe and its recovered pose replaces the held one in this
        frame's output. One host read per attempt."""
        if o["success"]:
            self._tracked_kf = int(o["anchor_id"]) + 1
        if o["success"] or o["anchor_id"] < 0:   # tracking, or no map yet
            self._fail_streak = 0
            return o
        self._fail_streak += 1
        if self._fail_streak < self.config.loop.reloc_after:
            return o
        if self._async is not None and self._async.inflight is not None:
            return o    # a pending merge would clobber the fresh anchor
        self._state, r = self._reloc(self._state, *frame_args,
                                     exclude_from_id=self._tracked_kf)
        res = reloc_to_host(r, self._state.map)
        if not res["success"]:
            return o
        self._fail_streak = 0
        self._tracked_kf = res["num_kf"]
        self.reloc_events.append(dict(
            frame=self._frame, matched_id=res["matched_id"],
            score=res["score"], inliers=res["inliers"]))
        return dict(o, success=True, added_kf=True, relocalized=True,
                    pose_q=res["pose_q"],
                    pose_t=res["pose_t"], num_inliers=res["inliers"],
                    anchor_id=res["num_kf"] - 1, anchor_q=res["pose_q"],
                    anchor_t=res["pose_t"])

    def _merge_inflight(self):
        merged, record = self._async.merge(self._state.map)
        self._state = self._state._replace(map=merged)
        self.ba_stats.append(record)

    def finish(self):
        """Wait for the solve in flight, if any, and merge it; then drain
        the loop probes it was deferring."""
        if self._async is not None and self._async.inflight is not None:
            self._merge_inflight()
        if self._loop is not None:
            self._state = self._loop.tick(self._state, self._frame, None)

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
