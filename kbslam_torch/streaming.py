"""Chunked streaming executor: C frames per dispatch.

Port of kbslam/streaming.py. The reference tracks a chunk of C frames in
one dispatch (a jitted ``lax.scan`` of the tracking step), uploads chunk
k+1 while chunk k computes and reads chunk k-1's outputs meanwhile. Here
the counterpart of that one dispatch is the replay of one CUDA graph:

- on the first full chunk the stream captures C ``track_step``s, after
  a warm-up on a side stream; frames go into static device input
  buffers, copied from two sets of pinned host buffers (one fills while
  the other uploads), the state lives in static buffers that each replay
  updates in place, and the C outputs land in one static row buffer,
  copied to one of two pinned host sets after each replay and followed
  by an event, so chunk k drains while chunk k+1 runs;
- a partial last chunk (``flush``) runs its frames through the same
  step eagerly, with the same function and the same draws, so it equals
  the replayed path by construction and the map is never copied;
- on the CPU (only when the caller's state lies there) a chunk is the
  same steps in a Python loop.

A capture that fails raises: nothing falls back to eager replay on the
card. The describe kernel launches on the current stream, so it is
captured with the step; its Python launch counter counts neither the
capture (nothing runs then) nor the replays, which ``replays`` counts
(a replay's kernels can be counted with ``torch.profiler``).

Options, as in the reference: ``chunk``, ``use_mask``, ``seed``,
``gray`` (the host converts RGB to uint8 luma with ``np.round`` and the
mask travels bit-packed, unpacked on the device) and ``ba_mode`` "off"
or "async". Results arrive at most 2C frames late. With "async", a
drained keyframe insertion starts a solve through the same
``ba.local_ba.AsyncLocalBA`` as ``slam.SLAM`` (on CUDA: the live map
copied into the static input of a captured local-BA graph, replayed on
a side stream); the result merges into the live map once its event has
completed (at most one solve in flight).

Keyframe culling, loop closure and relocalization run chunk-late, as in
the reference: a drained insertion culls, merges a finished solve, ticks
the loop runner (its probes deferred while a solve is in flight) and
dispatches a new solve last. When the drained frames end in
``reloc_after`` failures, ``feed`` drains the chunks in flight and
probes the newest drained frame against the ring; a probe whose frame
and map are unchanged since the last failed one is skipped (it would
fail again), and only the last frame of each dispatched chunk is kept
for it. On CUDA every map change made between replays (a cull, a merge,
a loop correction, a relocalization insertion) is copied into the
graph's static buffers (``assign_state``), so the next replay reads it.

The per-keyframe programs (the cull, the relocalization attempt, and
the volume's integrate or the atlas's submap start and fuse) are, on
CUDA, CUDA graphs too (``device.Programs``, by name in ``graphs``),
captured on those static buffers at their first call, on a stream and
in a memory pool of the stream's own, and replayed between the chunk
replays, as the per-frame shell replays them. Whatever changes from call
to call goes into static device tensors first (``device.Programs.
load``): the relocalized frame (through pinned memory; its packed mask
is unpacked inside the graph) and its exclusion id, a fused keyframe's
depth, pose and id, the atlas slot and the frame and anchor poses the
atlas fuses with (copies of ring rows, or of the drained pose and the
stored anchor).
``graph=False`` runs full chunks and these programs through the same
functions eagerly (on the card too), the yardstick of the replayed
path.

Dense mapping (``cfg.dense.enabled``) fuses chunk-late too: ``feed``
keeps each frame's host depth in a ring keyed by frame index, and each
drained keyframe is fused, as is a keyframe that relocalization inserts;
a drained frame leaves the ring. The monolithic volume fuses at the
drained pose. The submap atlas (``dense.submap_every > 0``) opens and
fuses submaps as the per-frame shell does, with the keyframe's global id
from a host count; its frame and anchor poses come from the live ring
(``_fusion_poses_now``). The depth and the poses go up through pinned
memory or are copied on the stream, so fusion adds no host sync. Dense
ICP runs on the per-frame path only (``ValueError``),
as in the reference: a rescue must act on the frame that failed, and a
chunk has already committed its frames.

``feed`` is traced (``utils.profiling``), each span with the index of
the chunk being staged: ``stream.stage`` (the frame into the staging
buffers, and the wait for that set's last upload), ``stream.dispatch``
(the uploads and the replay's launch), ``stream.drain`` (the wait for a
chunk's rows alone), ``stream.kf_tick`` and ``stream.reloc``; the counter
``stream.syncs`` counts each blocking host wait (a staging set's upload,
a chunk's rows, a relocalization's result, an asynchronous solve's
merge). The chunk graph's stage marks are read after each replay while
the recorder is on (``device.replay``), and its readings become records
once that chunk's copy has completed.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from kbslam_torch.ba.local_ba import AsyncLocalBA
from kbslam_torch.device import Programs, graph_capture, replay
from kbslam_torch.frontend.image import GRAY_WEIGHTS
from kbslam_torch.geom.camera import Intrinsics
from kbslam_torch.loop.reloc import (make_reloc_step, reloc_record,
                                     reloc_vector)
from kbslam_torch.loop.runner import LoopCloser
from kbslam_torch.mapping import dense, submap
from kbslam_torch.mapping.cull import make_cull
from kbslam_torch.pipeline import (OUTPUT_WIDTH, TrackOutput, TrackState,
                                   assign_state, clone_state, make_track_step,
                                   output_rows, row_to_fields)
from kbslam_torch.slam import DenseViews, check_dense_config
from kbslam_torch.utils import profiling


def unpack_mask_bits(packed: torch.Tensor, width: int) -> torch.Tensor:
    """[..., ceil(W/8)] uint8 (np.packbits, big-endian) -> [..., W] uint8
    in {0, 1}: the device-side unpack of the 1-bit-per-pixel mask."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8)[..., :width]


def make_chunk_step(cfg, intr: Intrinsics, chunk: int, use_mask: bool = False,
                    seed: int = 0, packed_mask: bool = False,
                    sampler_for_frame=None):
    """``run(state, rgb [n, H, W(, 3)], depth [n, H, W], mask [n, ...] or
    None) -> (state, TrackOutput stacked over n)`` for n <= chunk frames:
    the tracking step in a loop, each frame drawing the minimal sets of
    its own ``frame_count``. ``sampler_for_frame`` is passed on to
    ``make_track_step`` (it reads the frame number on the host, so it is
    for CPU tests, not for a captured graph)."""
    step = make_track_step(cfg, intr, use_mask=use_mask, seed=seed,
                           sampler_for_frame=sampler_for_frame)

    def run(state, rgb, depth, mask=None):
        if rgb.shape[0] > chunk:
            raise ValueError(f"{rgb.shape[0]} frames for a chunk of {chunk}")
        outs = []
        for i in range(rgb.shape[0]):
            m = None
            if use_mask:
                m = (unpack_mask_bits(mask[i], depth.shape[-1])
                     if packed_mask else mask[i])
            state, out = step(state, rgb[i], depth[i], m)
            outs.append(out)
        return state, TrackOutput(*(torch.stack(f) for f in zip(*outs)))
    return run


class _Pending(NamedTuple):
    """One dispatched chunk: its real frame count, the host rows its
    outputs land in, the event after their copy (None on the CPU), and
    its last frame's host arrays when relocalization may need them."""
    n_real: int
    rows: torch.Tensor
    event: Optional[torch.cuda.Event]
    last: Optional[list]


class ChunkedStream(DenseViews):
    """Double-buffered chunked tracking over a host frame stream.

    ``feed`` takes one frame and returns the results drained so far;
    every C-th frame dispatches a chunk. ``flush`` runs the partial last
    chunk, drains everything and merges a solve in flight. ``state`` is
    the live tracking state (on CUDA, the graph's static buffers); with
    dense mapping, ``tsdf`` is the volume and ``dense_surface``,
    ``dense_mesh``, ``render_view`` and ``map_consistency`` read it.
    ``graphs`` maps each per-keyframe program's name to its
    ``device.LiveGraphs`` on CUDA (empty on the CPU and with
    ``graph=False``)."""

    def __init__(self, cfg, intr: Intrinsics, state: TrackState,
                 chunk: int = 8, use_mask: bool = False, seed: int = 0,
                 gray: bool = False, ba_mode: str = "off",
                 graph: bool = True):
        if ba_mode not in ("off", "async"):
            raise ValueError(f"unknown ba_mode {ba_mode!r}")
        check_dense_config(cfg)
        if cfg.dense_icp.mode != "off":
            raise ValueError("dense_icp runs on the per-frame path only "
                             "(a rescue must act on the frame that failed; "
                             "a chunk has already committed its frames)")
        self.chunk = int(chunk)
        self.use_mask = use_mask
        self.gray = gray
        self.ba_mode = ba_mode
        self.ba_stats: List[dict] = []
        # bit-packed masks ride with gray ingress, as in the reference
        self._packed_mask = bool(use_mask and gray)
        self._run = make_chunk_step(cfg, intr, self.chunk, use_mask, seed,
                                    self._packed_mask)
        self._state = state
        self.device = state.pose_q.device
        self._cuda = self.device.type == "cuda"
        self._graph = None
        self.replays = 0           # replays of the chunk graph
        self._dev_in = None        # static device inputs [C, ...]
        self._staging = None       # two sets of (pinned) host inputs
        self._staged = [None, None]  # event after each set's upload
        self._slot = 0             # the staging set being filled
        self._n_host = 0           # frames in it
        self._rows_host = None     # two sets of host output rows
        self._rows_slot = 0
        self._rows_dev = None      # the graph's static output rows
        self._inflight: List[_Pending] = []
        self._drained: List[dict] = []
        self._frame = 0
        self._async = (AsyncLocalBA(cfg.ba, intr) if ba_mode == "async"
                       else None)
        self._graphed = graph
        # the per-keyframe programs: CUDA graphs on the stream's static
        # state, replayed between chunk replays (eager with graph=False)
        self._programs = Programs(self.device, graph)
        self.graphs: dict = self._programs.graphs
        program = self._programs.program
        self._cull = (program("cull", make_cull(cfg.cull)) if cfg.cull.enabled
                      else None)
        lc = cfg.loop
        # read once on the host: the runner and the fail streak count
        # on from the insertions the given map already holds
        num_kf = int(state.map.num_kf)
        self._loop = (LoopCloser(cfg, intr, num_kf=num_kf) if lc.enabled
                      else None)
        self.loop_events: List[dict] = (
            self._loop.events if self._loop is not None else [])
        self._reloc = self._relocalize = None
        if lc.reloc_after > 0:
            # the attempt calls the step by name (a CPU test may replace
            # it) and writes its new state into the stream's
            self._reloc = make_reloc_step(
                cfg, intr, use_mask=use_mask, word_bits=lc.word_bits,
                score_min=lc.reloc_score_min,
                min_inliers=lc.reloc_min_inliers, seed=seed)
            packed = self._packed_mask

            def attempt(state, rgb, depth, mask, exclude_from_id):
                if packed:
                    mask = unpack_mask_bits(mask, depth.shape[-1])
                new, r = self._reloc(state, rgb, depth, mask,
                                     exclude_from_id)
                assign_state(state, new)
                return reloc_vector(r, state.map)
            self._relocalize = program("reloc", attempt)
        self._reloc_after = lc.reloc_after
        self.reloc_events: List[dict] = []
        self._fail_streak = 0
        self._kf_seen = num_kf     # insertions seen in drained frames
        self._tracked_kf = num_kf  # insertions up to the last tracked frame
        self._last_fed = None      # the newest fed frame's host arrays
        self._probe_frame = None   # (index, arrays) of the newest drained
        self._map_changes = 0      # host count of map changes
        self._failed_probe = None  # (frame, map changes) of the last miss
        self.intr = intr
        self.dense_cfg = cfg.dense
        self._image_hw = (cfg.image_height, cfg.image_width)
        self._depth_scale = cfg.map.depth_scale
        self._last_kf_view = None  # (q, t, host depth, global kf id)
        self._fed = 0              # frames fed
        self.tsdf = self._integrate = self.atlas = None
        self._kf_insertions = 0       # keyframe frames fused into the atlas
        self._active_anchor_kid = -1  # global id of the newest anchor
        d, scale = cfg.dense, cfg.map.depth_scale
        self._dense = d.enabled
        if d.enabled and d.submap_every > 0:
            self.atlas = submap.empty_atlas(d, d.max_submaps, self.device)
            start, fuse = submap.make_submap_ops(d, intr, d.max_submaps,
                                                 scale)

            # the ring slot and the keyframe id are device tensors the
            # stream loads, so one graph serves every value
            def start_at(atlas, slot, q, t, kf_id):
                start(atlas, q, t, kf_id, slot=slot)

            def fuse_at(atlas, slot, depth_raw, q, t, anchor_q, anchor_t):
                fuse(atlas, depth_raw, q, t, anchor_q, anchor_t, slot=slot)

            self._submap_start = program("submap_start", start_at)
            self._submap_fuse = program("submap_fuse", fuse_at)
            self._submap_every = d.submap_every
            self._kf_cap = int(state.map.kf_id.shape[0])
            # the policy inserts keyframes at least this many frames apart
            self._min_frame_gap = max(1, int(cfg.policy.min_frame_gap))
        elif d.enabled:
            self.tsdf = dense.empty_tsdf(d, self.device)
            integrate = dense.make_integrate(d, intr, scale)
            self._integrate = program(
                "integrate", lambda s, *a: assign_state(s, integrate(s, *a)))
        if d.enabled:
            self._depth_ring: dict = {}   # frame index -> host depth

    @property
    def state(self) -> TrackState:
        return self._state

    # --- ingress --------------------------------------------------------
    def _host_frame(self, rgb, depth, mask):
        """The arrays one frame puts into the staging buffers."""
        rgb = np.asarray(rgb)
        if self.gray and rgb.ndim == 3:
            # round (not truncate): the u8 luma stays within 0.5 gray
            # levels of the device's float path
            rgb = np.round(rgb.astype(np.float32)
                           @ np.array(GRAY_WEIGHTS, np.float32)
                           ).astype(np.uint8)
        arrays = [np.asarray(rgb, np.uint8), np.asarray(depth, np.int32)]
        if self.use_mask:
            keep = (np.ones(arrays[1].shape, bool) if mask is None
                    else np.asarray(mask) != 0)
            if self._packed_mask:
                keep = np.packbits(keep, axis=-1)
            arrays.append(keep.astype(np.uint8))
        return arrays

    def _make_buffers(self, arrays):
        C = self.chunk
        pin = self._cuda

        def buf(a, **kw):
            return torch.empty((C,) + a.shape, dtype=torch.from_numpy(a).dtype,
                               **kw)
        self._staging = [[buf(a, pin_memory=pin) for a in arrays]
                         for _ in range(2)]
        self._rows_host = [torch.empty((C, OUTPUT_WIDTH), dtype=torch.float64,
                                       pin_memory=pin) for _ in range(2)]
        if self._cuda:
            self._dev_in = [buf(a, device=self.device) for a in arrays]

    def feed(self, rgb, depth, mask=None) -> List[dict]:
        """Add one frame; returns any newly drained per-frame results."""
        span = profiling.span
        k = self._fed // self.chunk       # the chunk being staged
        with span("stream.stage", k):
            arrays = self._host_frame(rgb, depth, mask)
            if self._dense:
                self._depth_ring[self._fed] = arrays[1]
            self._fed += 1
            if self._staging is None:
                self._make_buffers(arrays)
            if self._n_host == 0 and self._staged[self._slot] is not None:
                # this set's last upload must be done before it is refilled
                self._staged[self._slot].synchronize()
                profiling.count("stream.syncs")
            for buf, a in zip(self._staging[self._slot], arrays):
                buf[self._n_host].numpy()[...] = a
            self._n_host += 1
            if self._reloc is not None:
                self._last_fed = arrays
        if self._n_host == self.chunk:
            with span("stream.dispatch", k):
                self._dispatch(self.chunk)
        # keep ONE chunk in flight: drain older results while the newest
        # chunk computes
        added = 0
        while len(self._inflight) > 1:
            added += self._collect(self._inflight.pop(0))
        with span("stream.kf_tick", k):
            self._kf_tick(added)
        with span("stream.reloc", k):
            self._maybe_reloc()
        out, self._drained = self._drained, []
        return out

    def flush(self) -> List[dict]:
        """Run the partial last chunk, drain every result and merge the
        solve in flight (end of the sequence)."""
        if self._n_host:
            self._dispatch(self._n_host)
        added = 0
        while self._inflight:
            added += self._collect(self._inflight.pop(0))
        self._kf_tick(added, block=True)
        if self._async is not None and self._async.inflight is not None:
            self._kf_tick(0, block=True)     # a solve dispatched just above
        out, self._drained = self._drained, []
        return out

    # --- one chunk --------------------------------------------------------
    def _dispatch(self, n: int):
        """Track the n staged frames: a graph replay for a full chunk on
        CUDA, the eager step otherwise. Makes no host sync."""
        staged = self._staging[self._slot]
        rows_host = self._rows_host[self._rows_slot]
        self._map_changes += 1
        last = self._last_fed
        if not self._cuda:
            st, outs = self._run(self._state, *(b[:n] for b in staged))
            assign_state(self._state, st)
            rows_host[:n].copy_(output_rows(outs))
            self._inflight.append(_Pending(n, rows_host, None, last))
        else:
            for dst, src in zip(self._dev_in, staged):
                dst[:n].copy_(src[:n], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            self._staged[self._slot] = ev
            if n == self.chunk and self._graphed:
                if self._graph is None:
                    self._capture()
                replay(self._graph)
                self.replays += 1
                rows = self._rows_dev
            else:
                st, outs = self._run(self._state,
                                     *(b[:n] for b in self._dev_in))
                assign_state(self._state, st)
                rows = output_rows(outs)
            rows_host[:n].copy_(rows, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            self._inflight.append(_Pending(n, rows_host, done, last))
        self._slot ^= 1
        self._rows_slot ^= 1
        self._n_host = 0

    def _capture(self):
        """Capture C steps on the static buffers as one CUDA graph, after
        a warm-up on a copy of the state on a side stream (it builds the
        per-device constants and the kernel library, which a capture
        cannot do)."""
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._run(clone_state(self._state),
                      *(b[:1] for b in self._dev_in))
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with graph_capture(graph, name="chunk"):
            st, outs = self._run(self._state, *self._dev_in)
            self._rows_dev = output_rows(outs)
            assign_state(self._state, st)
        self._graph = graph

    def _collect(self, p: _Pending) -> int:
        """Read one chunk's outputs on the host; returns how many of its
        frames inserted a keyframe (the BA trigger)."""
        # under the index of the chunk being staged, as feed's spans
        with profiling.span("stream.drain", (self._fed - 1) // self.chunk):
            if p.event is not None:
                p.event.synchronize()
                profiling.count("stream.syncs")
        rows = p.rows[:p.n_real].numpy()
        added = 0
        for row in rows:
            o = row_to_fields(row)
            d = dict(frame=self._frame, success=bool(o["success"]),
                     added_kf=bool(o["added_kf"]),
                     pose_q=o["pose_q"].copy(), pose_t=o["pose_t"].copy(),
                     inlier_ratio=float(o["inlier_ratio"]),
                     num_matches=int(o["num_matches"]),
                     num_inliers=int(o["num_inliers"]),
                     num_features=int(o["num_features"]),
                     anchor_id=int(o["anchor_id"]),
                     anchor_q=o["anchor_q"].copy(),
                     anchor_t=o["anchor_t"].copy())
            self._drained.append(d)
            if self._dense:
                depth = self._depth_ring.pop(self._frame)
                if d["added_kf"]:
                    self._fuse_kf(d["pose_q"], d["pose_t"], depth,
                                  self._kf_seen)
            if d["success"]:
                self._tracked_kf = d["anchor_id"] + 1
            if self._reloc is not None:
                if d["success"] or self._kf_seen == 0:
                    self._fail_streak = 0
                else:
                    self._fail_streak += 1
            self._kf_seen += d["added_kf"]
            added += d["added_kf"]
            self._frame += 1
        if p.last is not None:
            self._probe_frame = (self._frame - 1, p.last)
        return added

    def _fuse_kf(self, q, t, depth, kid: int):
        """Fuse one keyframe's host depth, taken at the host pose (q, t),
        into the dense model; ``kid`` is its global keyframe id. The
        depth, the pose, the id and the atlas slot go into static device
        tensors (``device.Programs.load``), which the programs read. Makes
        no host sync."""
        self._last_kf_view = (np.asarray(q), np.asarray(t), depth, kid)
        load = self._programs.load
        depth = load("fuse_depth", depth, torch.int32)
        q, t = load("fuse_q", q), load("fuse_t", t)
        if self.atlas is None:
            self._integrate(self.tsdf, depth, q, t)
            return
        opens = self._kf_insertions % self._submap_every == 0
        if opens:
            self.atlas = self.atlas._replace(count=self.atlas.count + 1)
        slot = load("submap_slot", self.atlas.active_slot(), torch.int64)
        if opens:
            self._submap_start(self.atlas, slot, q, t,
                               load("kf_id", kid, torch.int32))
            self._active_anchor_kid = kid
        # the poses into static tensors too, so one graph serves every id
        static = self._programs.static
        self._submap_fuse(self.atlas, slot, depth, *(
            static(f"fuse_pose_{i}", p.shape).copy_(p)
            for i, p in enumerate(self._fusion_poses_now(kid, q, t))))
        self._kf_insertions += 1

    def restore_atlas(self, atlas, kf_insertions: int):
        """Go on with a saved atlas (a resume): its count of fused keyframe
        frames, and its newest anchor's id read from the atlas itself."""
        super().restore_atlas(atlas, kf_insertions)
        if atlas.count:
            self._active_anchor_kid = int(
                atlas.anchor_kf_id[atlas.active_slot()])

    def _fusion_poses_now(self, kid: int, q_drained, t_drained):
        """(frame q, frame t, anchor q, anchor t) on the device for fusing
        drained keyframe ``kid`` into the active submap.

        The frame pose and the anchor pose must live in one gauge
        (``submap.integrate_active``). A loop correction that landed
        while this chunk was in flight rewrote every ring pose, so the
        drained pose may predate it while the anchor's ring pose follows
        it. Both poses are therefore taken from the live ring at the same
        instant: stream-ordered copies of the two ring rows, made after
        the replay in flight and before the next, which rewrites the
        graph's static buffers in place (a view would read the next
        chunk's values).

        The ring row of global id ``a`` is overwritten by insertion ``a +
        cap``, so the ring is read only when no insertion can have
        reached ``anchor + cap``: a host-only bound. Of the frames in
        flight beyond this one, R, the step inserts only by the policy,
        at least ``min_frame_gap`` frames apart, except the empty-map
        insertion, which skips the gap: at most 1 + (R - 1) // gap
        insertions beyond ``kid``. Relocalization inserts too, but only
        after ``_maybe_reloc`` has drained every chunk in flight, so no
        frame is in flight when one lands, and the bound holds. When the
        bound fails (the anchor's slot may have been reallocated), the
        drained pose and the atlas's stored anchor pose are used: one
        gauge as long as no rigid correction landed since the submap
        opened, the per-frame shell's fallback for a reallocated
        anchor."""
        anchor = self._active_anchor_kid
        remaining = max(0, self._fed - self._frame - 1)
        extra = 1 + (remaining - 1) // self._min_frame_gap   # 0 when R == 0
        if anchor >= 0 and kid + extra < anchor + self._kf_cap:
            m = self._state.map
            fi, ai = kid % self._kf_cap, anchor % self._kf_cap
            return (m.kf_q[fi].clone(), m.kf_t[fi].clone(),
                    m.kf_q[ai].clone(), m.kf_t[ai].clone())
        s = self.atlas.active_slot()
        return q_drained, t_drained, self.atlas.anchor_q[s], \
            self.atlas.anchor_t[s]

    # --- chunk-late keyframe work -----------------------------------------
    def _kf_tick(self, n_added: int, block: bool = False):
        """Cull, merge a finished solve (or, with block, wait for it), tick
        the loop runner, then dispatch a new solve if the drained frames
        inserted a keyframe. ``n_added`` counts insertions among the
        DRAINED frames, never read off the state of a chunk in flight.
        Each map change is copied into the stream's state tensors."""
        a = self._async
        if n_added and self._cull is not None:
            self._cull(self._state.map)         # in place
            self._map_changes += 1
        if a is not None and a.inflight is not None and (block or a.ready()):
            merged, record = a.merge(self._state.map)
            profiling.count("stream.syncs")
            assign_state(self._state, self._state._replace(map=merged))
            self.ba_stats.append(record)
            self._map_changes += 1
        if self._loop is not None:
            if n_added:
                self._loop.note_insertions(n_added)
            st = self._loop.tick(self._state, self._frame,
                                 a.inflight if a is not None else None)
            if st is not self._state:
                assign_state(self._state, st)
                self._map_changes += 1
        if a is not None and n_added and a.inflight is None:
            a.dispatch(self._state.map)

    def _attempt(self, arrays) -> dict:
        """One relocalization attempt on the frame's host ``arrays``
        against keyframes inserted before ``_tracked_kf``: the frame and
        the exclusion id go into the program's static tensors, and the
        result comes back in one copy (``loop.reloc.reloc_record``)."""
        load = self._programs.load
        res = reloc_record(self._relocalize(
            self._state, load("reloc_rgb", arrays[0], torch.uint8),
            load("reloc_depth", arrays[1], torch.int32),
            load("reloc_mask", arrays[2], torch.uint8) if self.use_mask
            else None,
            load("reloc_exclude", self._tracked_kf, torch.int32)
        ).cpu().numpy())
        profiling.count("stream.syncs")
        return res

    def _maybe_reloc(self):
        """Chunk-late relocalization: when the drained frames end in
        ``reloc_after`` failures and no solve is in flight (its merge
        would clobber the fresh anchor), drain the chunks in flight (one
        may have recovered on its own) and probe the newest drained
        frame, against the keyframes inserted up to the last tracked
        frame. On success the frame is a new keyframe, reported to the
        loop runner like any insertion."""
        def waits():
            return (self._fail_streak < self._reloc_after
                    or (self._async is not None
                        and self._async.inflight is not None))

        if self._reloc is None or waits():
            return
        if self._inflight:
            added = 0
            while self._inflight:
                added += self._collect(self._inflight.pop(0))
            self._kf_tick(added)
            if waits():
                return
        if self._probe_frame is None:
            return
        frame, arrays = self._probe_frame
        if self._failed_probe == (frame, self._map_changes):
            return      # the same frame on the same map: the same miss
        res = self._attempt(arrays)
        if not res["success"]:
            self._failed_probe = (frame, self._map_changes)
            return
        self._map_changes += 1
        self._fail_streak = 0
        self._kf_seen += 1
        self._tracked_kf = res["num_kf"]
        if self._dense:
            # the relocalized frame is a keyframe: its depth joins the
            # model like any drained insertion's. Its id is the map's
            # count less one, passed on: ``_kf_seen`` already counts it
            self._fuse_kf(res["pose_q"], res["pose_t"], arrays[1],
                          res["num_kf"] - 1)
        if self._loop is not None:
            self._loop.note_insertions()
        self.reloc_events.append(dict(
            frame=frame, matched_id=res["matched_id"], score=res["score"],
            inliers=res["inliers"]))
