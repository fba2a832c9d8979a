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
finished asynchronous solve), the relocalization tick, the dense ICP tick
(``config.dense_icp``, ``mapping/icp.py``), dense fusion of a keyframe's
depth (``config.dense.enabled``: the monolithic TSDF volume of
``mapping/dense.py``, or with ``dense.submap_every > 0`` the submap atlas
of ``mapping/submap.py``), the loop tick, and the asynchronous dispatch
last, so a new solve sees the corrected map.

``run_global_ba`` refines every keyframe of the ring and its landmarks
with the guarded global bundle adjustment of ``ba/global_ba.py``, at the
end of a run (the CLI's ``--global-ba``); on CUDA a solve at a shape
seen before replays a CUDA graph (``run_global_ba_on_map``).

On CUDA every program the reference jits runs as a CUDA graph
(``device.LiveGraphs``, made by ``device.Programs``): the tracking step
(``pipeline.track_step_into``), the cull, the local BA after a keyframe, the
relocalization attempt, the fusion of a keyframe (the volume's
``integrate``, the atlas's submap start and fuse) and the dense ICP
solve, each captured at its first call for its tensors, after a
warm-up on copies, and replayed after. The shell keeps one live state
(and one volume or atlas) and every program writes into its tensors
in place, as does every other map change (a merge, a loop correction,
a global BA, a new ``state``): the counterpart of the reference's
donated state, so ``state`` is overwritten by the next ``process``
(``pipeline.clone_state`` keeps a copy). The frame goes into static
device buffers through pinned host buffers, the relocalization's
exclusion id, an atlas keyframe's id and the atlas slot to open or fuse
into device scalars, and the poses that fusion and ICP start from into
static device vectors, so a replay copies nothing outside its graph.
The graphs share one memory pool (each one's outputs are read before
another replays) and are captured on a stream of the shell's own, whose
cuBLAS workspace no concurrent graph bakes in. A capture that fails raises; nothing falls
back to the eager path. On the CPU (only when the caller names it) the
same programs run eagerly on the same live tensors.

With the atlas, fusion makes no host read: the anchor's id comes from a
host count of insertions, and its current ring pose (or the stored one,
when its ring slot was reallocated) is chosen on the device, so the
default path keeps its one host sync per frame. The dense ICP tick reads
its result once per solve, and against the atlas first reads the map
ring and the anchors to choose its window of submaps
(``submap.recent_slots_with_poses``, host-side as in the reference: six
reads).

``process`` is traced (``utils.profiling``): the span ``shell.process``
(with the frame's index) and inside it ``shell.upload``, ``shell.track``
(the replay's launch and the output wait), ``shell.cull``, ``shell.ba``,
``shell.ticks`` (relocalization, ICP, fusion, the loop) and
``shell.record``; inside ``shell.ticks``, ``shell.icp`` (the atlas's slot
choice, the ICP replay and its result read) and ``shell.fuse`` (a
keyframe's fusion). The counter ``shell.syncs``, one per blocking host
read (the track output, a solve's stats, a relocalization's or an ICP
solve's result, each of the six reads of the atlas's slot choice, an
asynchronous solve's merge), and a solve's LM trips; ``dense.icp_solves``
and ``dense.icp_accepted``, ``dense.fusions`` and
``dense.submaps_opened``. With the recorder on, the frame's upload is
marked on the device (``upload``, between two marks of a
``profiling.Marks`` named ``shell``).
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from kbslam_torch.ba.local_ba import (AsyncLocalBA, count_trips,
                                      make_local_ba_into, stats_record)
from kbslam_torch.convert import tsdf_to_numpy
from kbslam_torch.device import Programs, assign_state, pick_device
from kbslam_torch.geom.camera import Intrinsics
from kbslam_torch.geom.se3 import quat_rotate
from kbslam_torch.loop.reloc import (make_reloc_step_into, reloc_record,
                                     reloc_vector)
from kbslam_torch.loop.runner import LoopCloser
from kbslam_torch.mapping import dense, icp, mesh, raycast, submap
from kbslam_torch.mapping.cull import make_cull
from kbslam_torch.pipeline import (init_state, make_track_step, output_rows,
                                   row_to_fields, track_step_into)
from kbslam_torch.utils import profiling


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
    """All TrackOutput fields of one frame in ONE device-to-host copy."""
    stacked = type(out)(*(f[None] for f in out))
    return row_to_fields(output_rows(stacked)[0].cpu().numpy())


def reloc_to_host(r, m) -> dict:
    """A relocalization attempt's result (``loop.reloc.RelocResult``) and
    the map after it, in one device-to-host copy (``loop.reloc.
    reloc_record``)."""
    return reloc_record(reloc_vector(r, m).cpu().numpy())


def _icp_vector(r) -> torch.Tensor:
    """An ``IcpResult`` as one vector: q, t, num_valid, rmse_init, rmse."""
    return torch.cat([r.q, r.t, torch.stack([r.num_valid.to(r.q.dtype),
                                             r.rmse_init, r.rmse])])


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


def run_global_ba_on_map(map_state, intr: Intrinsics, ba_cfg, steps: int = 5,
                         pcg_iters: int = 30, group=None, graph: bool = True):
    """A guarded global bundle adjustment over every keyframe of the ring
    (``ba/global_ba.global_ba_solve``: ``steps`` LM rounds, PCG capped at
    ``pcg_iters``), with the oldest real keyframe held fixed. Returns
    (new map state, the per-round costs as floats). One host read of the
    insertion count sizes the problem, and one of the costs ends it.

    On CUDA the solve is one CUDA graph per problem shape
    (``global_ba.replayed_global_solve``): the first call with a shape
    solves eagerly, the second captures and replays, later ones replay.
    A captured graph stays for the life of the process (of the group,
    over a ``group``), one per window size that came back. On the CPU,
    or with ``graph=False`` (the yardstick), the solve runs eagerly.

    Over a ``group`` (``parallel.dist.ShardGroup``) every rank holds the
    same map, solves its block of the cameras and returns the whole new
    map; the window is a multiple of the world size W (the ring's
    capacity rounded down to one, short windows padded up to one), and a
    ring of fewer than W keyframes raises ``ValueError``. On NCCL the
    graph holds the solve's collectives; on gloo the solve is eager."""
    from kbslam_torch.ba.global_ba import (from_map_state,
                                           gather_global_data,
                                           make_global_solve,
                                           replayed_global_solve,
                                           shard_global_data, write_back)

    world = 1 if group is None else group.world
    # never wider than the ring: after a wrap, a wider window would
    # alias one slot into two real rows (observations counted twice)
    cap = (map_state.capacity_kf // world) * world
    if cap < world:
        raise ValueError(f"a ring of {map_state.capacity_kf} keyframes "
                         f"cannot be split over {world} ranks")
    n_kf = min(int(map_state.num_kf), cap)
    n_cams = max(-(-n_kf // world) * world, world)
    data, slots, real = from_map_state(map_state, intr, ba_cfg, n_cams)
    if group is not None:
        data = shard_global_data(data, group)
    settings = (intr, steps, pcg_iters, ba_cfg.depth_residuals,
                ba_cfg.huber_delta, group)
    if data.cam_q.is_cuda and graph:
        data, costs = replayed_global_solve(*settings)(data)
        # out of the graph's memory, which the next replay rewrites
        data = data._replace(mp_pos=data.mp_pos.clone())
    else:
        data, costs = make_global_solve(*settings)(data)
    if group is not None:
        data = gather_global_data(data, group)
    return (write_back(map_state, data, slots, real),
            [float(c) for c in costs.cpu().numpy()])


def check_dense_config(config):
    """Raise what the reference raises on the dense options: dense ICP
    needs the dense model, and its mode must be known."""
    mode = config.dense_icp.mode
    if mode != "off":
        if not config.dense.enabled:
            raise ValueError("dense_icp requires dense.enabled "
                             "(the TSDF volume is the model)")
        if mode not in ("rescue", "refine"):
            raise ValueError(f"unknown dense_icp.mode {mode!r}")


def anchor_pose_now(atlas, map_state, slot=None):
    """(q, t) on the device of the active submap's anchor keyframe at its
    current ring pose, or the stored anchor pose when the ring slot was
    reallocated: the gauge the frame poses live in. Chosen by a device
    ``where`` over rows picked by ``index_select``, so no host read.
    ``slot``: the active atlas slot as a 0-d device tensor (default: from
    the host count)."""
    s = submap.slot_index(atlas, atlas.active_slot() if slot is None
                          else slot)
    kid = atlas.anchor_kf_id.index_select(0, s).to(torch.int64)    # [1]
    ring = kid % map_state.kf_id.shape[0]
    live = (kid >= 0) & (map_state.kf_id.index_select(0, ring) == kid)
    return (torch.where(live, map_state.kf_q.index_select(0, ring)[0],
                        atlas.anchor_q.index_select(0, s)[0]),
            torch.where(live, map_state.kf_t.index_select(0, ring)[0],
                        atlas.anchor_t.index_select(0, s)[0]))


class DenseViews:
    """The read side of the dense model, shared by ``SLAM`` and
    ``streaming.ChunkedStream``. The shell sets ``tsdf`` (the monolithic
    volume) or ``atlas`` (the submap atlas), or neither with dense mapping
    off, and ``dense_cfg``, ``intr``, ``_image_hw``, ``_depth_scale`` and
    ``_last_kf_view`` (pose, host depth and global id of the newest fused
    keyframe); ``state`` is the live tracking state. The atlas is read by
    its anchors' current ring poses (host-side, not hot)."""

    def restore_atlas(self, atlas, kf_insertions: int):
        """Go on with a saved atlas (a resume) and its count of fused
        keyframe frames, so new submaps open in phase."""
        self.atlas, self._kf_insertions = atlas, kf_insertions

    def _anchor_poses_now(self) -> dict:
        return submap.anchor_poses_now(self.atlas, self.state.map)

    def dense_surface(self) -> tuple:
        """Zero-crossing point cloud of the model: (points [M, 3] world,
        |tsdf| residual [M]) (``mapping/dense.surface_points``; with the
        atlas, the union of its submaps' surfaces, each re-posed by its
        anchor's current pose)."""
        if self.atlas is not None:
            return submap.extract_atlas_surface(self.atlas, self.dense_cfg,
                                                self._anchor_poses_now())
        if self.tsdf is None:
            raise RuntimeError("dense mapping disabled "
                               "(SLAMConfig.dense.enabled)")
        return dense.surface_points(self.tsdf, self.dense_cfg)

    def dense_mesh(self) -> mesh.TriangleMesh:
        """The model's zero isosurface (``mapping/mesh.marching_tetrahedra``,
        host-side): one welded mesh of the volume, or the atlas's
        per-submap meshes re-posed by their anchors and concatenated."""
        if self.atlas is not None:
            return submap.atlas_mesh(self.atlas, self.dense_cfg,
                                     self._anchor_poses_now())
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

    def _last_view(self):
        """(q, t, host depth) of the newest fused keyframe, or None. The
        monolithic volume is never re-warped, so its keyframe is viewed
        from the pose it was fused at. The atlas follows corrections, so
        the keyframe is viewed from its current ring pose (the pose it
        was fused at once its ring slot was reallocated): the fused pose
        would mix the gauge of the fusion with that of the re-posed
        anchor."""
        if self._last_kf_view is None:
            return None
        q, t, depth, kid = self._last_kf_view
        if self.atlas is not None:
            m = self.state.map
            i = kid % m.kf_id.shape[0]
            if kid >= 0 and int(m.kf_id[i]) == kid:
                q, t = m.kf_q[i].cpu().numpy(), m.kf_t[i].cpu().numpy()
        return q, t, depth

    def render_view(self, q=None, t=None, stride: int = 1):
        """Raycast the model from camera-to-world (q, t), by default the
        newest fused keyframe's (``_last_view``): a ``RaycastResult`` with
        world normals on the model's device, or None before the first
        fused keyframe. Give both of q and t or neither. ``stride``
        renders every stride-th pixel (the full 640x480 render marches
        20M samples). The atlas renders its active submap, re-posed by
        its anchor's current ring pose."""
        if (q is None) != (t is None):
            raise ValueError("render_view takes both q and t, or neither")
        if q is None:
            view = self._last_view()
            if view is None:
                return None
            q, t, _ = view
        vol, pose, anchor = raycast.resolve_render_model(
            self.tsdf, self.atlas, self.state.map, q, t)
        if vol is None:
            return None
        intr_s, H, W = self._scaled_intr(stride)
        r = raycast.make_raycast(self.dense_cfg, intr_s, H, W)(
            vol, pose.q, pose.t)
        if anchor is not None:
            # the submap's normals come back in its local frame
            n = quat_rotate(anchor.q, r.normal.reshape(-1, 3))
            r = r._replace(normal=n.reshape(r.normal.shape))
        return r

    def map_consistency(self, stride: int = 2) -> Optional[dict]:
        """Rendered against observed depth at the newest fused keyframe
        (``mapping/raycast.render_consistency``, from ``_last_view``'s
        pose): median and p90 error and coverage, or None before the
        first fused keyframe."""
        view = self._last_view()
        if view is None:
            return None
        q, t, depth = view
        vol, pose, _ = raycast.resolve_render_model(
            self.tsdf, self.atlas, self.state.map, q, t)
        if vol is None:
            return None
        intr_s, H, W = self._scaled_intr(stride)
        depth_m = (np.asarray(depth, np.float32)[::stride, ::stride]
                   * self._depth_scale)[:H, :W]
        return raycast.render_consistency(vol, pose, depth_m, intr_s,
                                          self.dense_cfg)


class SLAM(DenseViews):
    """Stateful wrapper: feed RGB-D frames, read back trajectory and map.

    ``graphs`` maps each program's name to its ``device.LiveGraphs`` on
    CUDA (empty on the CPU): their replays, captures and capture
    seconds."""

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
        self._programs = Programs(self.device)
        self.graphs: dict = self._programs.graphs
        # through ``_step``, which a CPU test may replace with a step that
        # draws the reference's minimal sets (``sampler_for_frame``; a
        # graph would replay the first frame's)
        self._step = make_track_step(config, self.intr, use_mask=use_mask,
                                     seed=seed)
        self._track = self._program(
            "track", lambda *a: track_step_into(self._step, *a))
        self._ba = (self._program("ba", make_local_ba_into(config.ba,
                                                           self.intr))
                    if ba_mode == "on_keyframe" else None)
        self._async = (AsyncLocalBA(config.ba, self.intr)
                       if ba_mode == "async" else None)
        self._cull = (self._program("cull", make_cull(config.cull))
                      if config.cull.enabled else None)
        lc = config.loop
        self._loop = (LoopCloser(config, self.intr) if lc.enabled else None)
        self._reloc = (self._program("reloc", make_reloc_step_into(
            config, self.intr, use_mask=use_mask, word_bits=lc.word_bits,
            score_min=lc.reloc_score_min, min_inliers=lc.reloc_min_inliers,
            seed=seed)) if lc.reloc_after > 0 else None)
        self._fail_streak = 0
        # keyframes from this id on were inserted while tracking failed
        # (at held poses): relocalization does not match them
        self._tracked_kf = 0
        # the runner's event list itself
        self.loop_events: List[dict] = (
            self._loop.events if self._loop is not None else [])
        self.reloc_events: List[dict] = []
        self._state = init_state(config, self.device)
        self._frame_bufs: dict = {}  # (name, shape, dtype) -> (host, device)
        self._upload_marks = None    # a profiling.Marks on CUDA, once on
        self._frame = 0
        self.trajectory: List[np.ndarray] = []   # poses of successes
        self.frame_poses: List[np.ndarray] = []  # per input frame
        self.frame_anchors: List[tuple] = []     # (anchor kf id, T_anchor)
        self.diagnostics: List[dict] = []
        self.ba_stats: List[dict] = []
        self.dense_cfg = config.dense
        self._image_hw = (config.image_height, config.image_width)
        self._depth_scale = config.map.depth_scale
        self._last_kf_view = None   # (q, t, host depth, global kf id)
        self.tsdf = self.atlas = None
        self._kf_insertions = 0     # keyframe frames fused into the atlas
        self._num_kf = 0            # the map's insertions, counted here
        d, scale = config.dense, config.map.depth_scale
        if d.enabled and d.submap_every > 0:
            self.atlas = submap.empty_atlas(d, d.max_submaps, self.device)
            start, fuse = submap.make_submap_ops(d, self.intr, d.max_submaps,
                                                 scale)

            # the ring slot is a device scalar the caller loads
            def start_at(atlas, slot, q, t, kf_id):
                start(atlas, q, t, kf_id, slot=slot)

            def fuse_at(atlas, slot, ring, depth_raw, q, t):
                fuse(atlas, depth_raw, q, t,
                     *anchor_pose_now(atlas, ring, slot), slot=slot)

            self._submap_start = self._program("submap_start", start_at)
            self._submap_fuse = self._program("submap_fuse", fuse_at)
        elif d.enabled:
            self.tsdf = dense.empty_tsdf(d, self.device)
            integrate = dense.make_integrate(d, self.intr, scale)
            self._integrate = self._program(
                "integrate", lambda s, *a: assign_state(s, integrate(s, *a)))
        self._icp = self._icp_atlas = None
        if config.dense_icp.mode != "off":
            # with the atlas: the newest dense_icp.atlas_slots submaps,
            # re-posed by their anchors' current ring poses
            if self.atlas is not None:
                run = icp.make_icp_atlas(d, config.dense_icp, self.intr, scale)
                self._icp_atlas = self._program(
                    "icp_atlas", lambda *a: _icp_vector(run(*a)))
            else:
                run = icp.make_icp(d, config.dense_icp, self.intr, scale)
                self._icp = self._program("icp",
                                          lambda *a: _icp_vector(run(*a)))
        self._last_icp_qt = None    # chained rescue poses (host)
        self.icp_events: List[dict] = []

    def _program(self, name, fn):
        """``fn`` as the shell calls it (``device.Programs.program``): on
        CUDA replayed as CUDA graphs (``graphs[name]``), on the CPU run
        eagerly."""
        return self._programs.program(name, fn)

    def _load(self, name, array, dtype=torch.float32) -> torch.Tensor:
        """The static device tensor ``name`` with the host ``array``
        copied in (``device.Programs.load``)."""
        return self._programs.load(name, array, dtype)

    @property
    def state(self):
        """The live tracking state: the next ``process`` overwrites its
        tensors in place (``pipeline.clone_state`` keeps a copy)."""
        return self._state

    @state.setter
    def state(self, value):
        """Replace the tracking state (a resume) by copying ``value`` into
        the live tensors (``ValueError`` on a shape or dtype mismatch):
        the loop runner counts its ordinals on from the new map's
        insertions."""
        assign_state(self._state, value)
        self._tracked_kf = self._num_kf = int(value.map.num_kf)
        if self._loop is not None:
            self._loop.start_at(self._tracked_kf)

    def _upload(self, rgb, depth, mask):
        """The frame in the shell's static device buffers, which the
        graphs read. On CUDA it goes through pinned host buffers with
        asynchronous copies, so the upload makes no host sync and
        allocates nothing; the host buffers are reused on the next frame,
        after this frame's output copy has waited for the stream. A
        frame without a mask gets a ones mask, filled once."""
        dev = self.device
        # torch's uint16 support is thin: widen depth to int32 on upload
        frame = [np.asarray(rgb, np.uint8), np.asarray(depth, np.int32)]
        if self.use_mask and mask is not None:
            frame.append(np.asarray(mask))
        pairs = []
        for name, a in zip(("rgb", "depth", "mask"), frame):
            k = (name, a.shape, a.dtype)
            if k not in self._frame_bufs:
                h = torch.from_numpy(np.empty(a.shape, a.dtype))
                if dev.type == "cuda":
                    h = h.pin_memory()
                    self._frame_bufs[k] = (h, torch.empty_like(h, device=dev))
                else:
                    self._frame_bufs[k] = (h, h)
            h, b = self._frame_bufs[k]
            np.copyto(h.numpy(), a)
            pairs.append((h, b))
        bufs = [b for _, b in pairs]
        self._mark_upload(None, bufs[0])
        for h, b in pairs:
            if b is not h:
                b.copy_(h, non_blocking=True)
        self._mark_upload("upload", bufs[0])
        rgb_t, depth_t = bufs[:2]
        mask_t = None
        if self.use_mask:
            if mask is not None:
                mask_t = bufs[2]
            else:
                k = ("ones_mask", rgb_t.shape[:2], torch.uint8)
                statics = self._programs.statics
                mask_t = statics.get(k)
                if mask_t is None:
                    mask_t = statics[k] = torch.ones(
                        rgb_t.shape[:2], dtype=torch.uint8, device=dev)
        return rgb_t, depth_t, mask_t

    def _mark_upload(self, stage, like):
        """A mark of the upload's copies: on CUDA, with the recorder on, in
        the shell's own ``profiling.Marks`` (read after the second), on
        the CPU the host clock's (``profiling.mark``)."""
        if not like.is_cuda:
            profiling.mark(stage, like)
            return
        if not profiling.enabled():
            return
        if self._upload_marks is None:
            self._upload_marks = profiling.Marks("shell", self.device, 2)
        m = self._upload_marks
        if stage is None:
            m.labels.clear()
        elif len(m.labels) != 1:
            return      # the recorder came on between the two marks
        m.add(stage)
        if stage is not None:
            m.read()

    def process(self, rgb, depth, mask=None) -> dict:
        """Track one frame (rgb [H, W, 3] uint8, depth [H, W] uint16)."""
        with profiling.span("shell.process", self._frame):
            return self._process(rgb, depth, mask)

    def _process(self, rgb, depth, mask) -> dict:
        span, count = profiling.span, profiling.count
        with span("shell.upload"):
            args = self._upload(rgb, depth, mask)
        t0 = time.perf_counter()
        with span("shell.track"):
            o = row_to_fields(self._track(self._state, *args)[0].cpu().numpy())
            count("shell.syncs")

        if self._cull is not None and o["added_kf"]:
            with span("shell.cull"):
                self._cull(self._state.map)

        ran_ba = False
        if self.ba_mode == "on_keyframe" and o["added_kf"]:
            with span("shell.ba"):
                tb = time.perf_counter()
                v = self._ba(self._state.map).cpu().numpy()
                count("shell.syncs")
                self.ba_stats.append(stats_record(
                    v, wall_ms=(time.perf_counter() - tb) * 1e3))
                count_trips(self.ba_stats[-1], self.config.ba)
            ran_ba = True
        elif self.ba_mode == "async":
            # merge a finished solve first, so the probes below see a
            # quiet pipe; a new one is dispatched last
            ran_ba = self._async.ready()
            if ran_ba:
                with span("shell.ba"):
                    self._merge_inflight()

        with span("shell.ticks"):
            o = self._ticks(o, args, depth)

        with span("shell.record"):
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

    def _ticks(self, o, args, depth):
        """The frame's relocalization, ICP, fusion and loop ticks, and the
        asynchronous solve's dispatch; returns the frame's output."""
        # a failed frame may insert by the policy and again by
        # relocalization: the runner hears of both
        inserted = int(bool(o["added_kf"]))
        if self._reloc is not None:
            o = self._reloc_tick(o, args)
            inserted += int(o.get("relocalized", False))

        self._num_kf += inserted
        # dense ICP after the reloc tick (a relocalized frame is a
        # keyframe and skips refine) and before fusion, so a rescued pose
        # is the one the model would see
        if self._icp is not None or self._icp_atlas is not None:
            with profiling.span("shell.icp"):
                o = self._icp_tick(o, args[1])

        # dense fusion after the reloc tick (a relocalized frame is a
        # keyframe at its recovered pose) and before the loop tick
        if self.config.dense.enabled and o["added_kf"]:
            with profiling.span("shell.fuse"):
                self._fuse(o, args[1])
            self._last_kf_view = (np.asarray(o["pose_q"]),
                                  np.asarray(o["pose_t"]), depth,
                                  self._num_kf - 1)

        inflight = self._async.inflight if self._async is not None else None
        if self._loop is not None:
            if inserted:
                self._loop.note_insertions(inserted)
            assign_state(self._state, self._loop.tick(self._state,
                                                      self._frame, inflight))

        if (self.ba_mode == "async" and o["added_kf"]
                and self._async.inflight is None):
            self._async.dispatch(self._state.map)
        return o

    def _fuse(self, o, depth_dev):
        """Fuse the keyframe's depth at its pose: into the volume, or into
        the active submap of the atlas, opening one anchored at this
        keyframe on every ``submap_every``-th insertion. Makes no host
        read. The anchor pose is the anchor's current ring pose: a
        correction between this fusion and the last moved the frame pose
        and the anchor alike, and the loop tick, the one rigid gauge
        change, comes after fusion (an asynchronous BA merge holds the
        window's newest keyframe fixed, so it is no gauge change)."""
        q = self._load("fuse_q", o["pose_q"])
        t = self._load("fuse_t", o["pose_t"])
        profiling.count("dense.fusions")
        if self.atlas is None:
            self._integrate(self.tsdf, depth_dev, q, t)
            return
        opens = self._kf_insertions % self.config.dense.submap_every == 0
        if opens:
            profiling.count("dense.submaps_opened")
            self.atlas = self.atlas._replace(count=self.atlas.count + 1)
        slot = self._load("submap_slot", self.atlas.active_slot(), torch.int64)
        if opens:
            kid = self._load("kf_id", self._num_kf - 1, torch.int32)
            self._submap_start(self.atlas, slot, q, t, kid)
        self._submap_fuse(self.atlas, slot, self._state.map, depth_dev, q, t)
        self._kf_insertions += 1

    def _icp_tick(self, o, depth_dev) -> dict:
        """The frame-to-model tick (``config.dense_icp``):

        - PnP failed ("rescue" and "refine"): align the depth frame to
          the model from the last emitted pose (chained across rescues in
          a row, which the device's held pose does not know) and, when
          the gates pass, emit the recovered pose as a success. The map
          is untouched: the next PnP still anchors to the last keyframe,
          as in the reference, but the trajectory keeps flowing through
          texture starvation. The fail streak is not reset: the sparse
          pipeline is still lost, and relocalization must still fire on
          schedule.
        - PnP succeeded, "refine": polish the pose against the model,
          accepted only when the robust SDF RMSE strictly improves;
          skipped on keyframe frames, whose pose belongs to the sparse
          map and BA.

        The model is the volume, or the newest ``dense_icp.atlas_slots``
        submaps re-posed by their anchors' current ring poses; refine
        leaves out the active submap, so that the polish rests on
        geometry not fused under the most recent drift. One host read per
        solve, and against the atlas six more for the window."""
        cfg = self.config.dense_icp
        ok = bool(o["success"])
        if ok:
            self._last_icp_qt = None
            if cfg.mode != "refine" or o["added_kf"]:
                return o
            q0, t0 = o["pose_q"], o["pose_t"]
        elif self._last_icp_qt is not None:
            q0, t0 = self._last_icp_qt
        else:   # the held pose: the last one the device knows
            q0, t0 = o["pose_q"], o["pose_t"]
        q0 = self._load("icp_q", q0)
        t0 = self._load("icp_t", t0)
        if self._icp is not None:
            v = self._icp(self.tsdf, depth_dev, q0, t0)
        else:
            win = submap.recent_slots_with_poses(
                self.atlas, self._state.map, cfg.atlas_slots,
                exclude_active=ok, syncs="shell.syncs")
            if win is None:
                return o    # no (independent) submap yet
            slots, aq, at = win
            v = self._icp_atlas(self.atlas,
                                self._load("icp_slots", slots, torch.int32),
                                self._load("icp_aq", aq),
                                self._load("icp_at", at), depth_dev, q0, t0)
        v = v.cpu().numpy()
        profiling.count("shell.syncs")
        profiling.count("dense.icp_solves")
        q, t, n, rmse_init, rmse = v[:4], v[4:7], int(v[7]), v[8], v[9]
        accepted = bool(n >= cfg.min_points and rmse <= cfg.accept_rmse_m
                        and rmse <= rmse_init)
        if ok:      # refine: a strict improvement too
            accepted = accepted and bool(rmse < rmse_init)
        if accepted:
            profiling.count("dense.icp_accepted")
        self.icp_events.append(dict(
            frame=self._frame, mode="refine" if ok else "rescue",
            accepted=accepted, num_valid=n, rmse_init=float(rmse_init),
            rmse=float(rmse)))
        if not accepted:
            return o
        if not ok:
            self._last_icp_qt = (q, t)
        return dict(o, success=True, pose_q=q, pose_t=t)

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
        exclude = self._load("reloc_exclude", self._tracked_kf, torch.int32)
        res = reloc_record(self._reloc(self._state, *frame_args,
                                       exclude).cpu().numpy())
        profiling.count("shell.syncs")
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
        profiling.count("shell.syncs")
        assign_state(self._state.map, merged)
        self.ba_stats.append(record)

    def finish(self):
        """Wait for the solve in flight, if any, and merge it; then drain
        the loop probes it was deferring."""
        if self._async is not None and self._async.inflight is not None:
            self._merge_inflight()
        if self._loop is not None:
            assign_state(self._state, self._loop.tick(self._state,
                                                      self._frame, None))

    def run_global_ba(self, steps: int = 5, pcg_iters: int = 30,
                      group=None) -> list:
        """A global bundle adjustment over every keyframe of the ring
        (``run_global_ba_on_map``, camera-sharded over ``group`` when one
        is given), written into the live map; returns the per-round
        costs."""
        new_map, costs = run_global_ba_on_map(
            self.state.map, self.intr, self.config.ba, steps=steps,
            pcg_iters=pcg_iters, group=group)
        assign_state(self._state.map, new_map)
        return costs

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
