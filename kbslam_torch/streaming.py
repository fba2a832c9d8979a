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

Culling, loop closure, relocalization and dense mapping are later slices
of the port (ROADMAP.md) and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from kbslam_torch.ba.local_ba import AsyncLocalBA
from kbslam_torch.device import graph_capture
from kbslam_torch.frontend.image import GRAY_WEIGHTS
from kbslam_torch.geom.camera import Intrinsics
from kbslam_torch.mapping.state import device_copy
from kbslam_torch.pipeline import TrackOutput, TrackState, make_track_step
from kbslam_torch.slam import OUTPUT_WIDTH, output_rows, row_to_fields


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


def clone_state(state: TrackState) -> TrackState:
    """A state whose every tensor is a fresh copy."""
    return TrackState(device_copy(state.map),
                      *(t.clone() for t in state[1:]))


def assign_state(dst: TrackState, src: TrackState) -> TrackState:
    """Copy ``src`` into ``dst``'s tensors, in place (a field that is
    already the same tensor is skipped); returns ``dst``."""
    for d, s in zip(list(dst.map) + list(dst[1:]),
                    list(src.map) + list(src[1:])):
        if d.data_ptr() != s.data_ptr():
            d.copy_(s)
    return dst


class _Pending(NamedTuple):
    """One dispatched chunk: its real frame count, the host rows its
    outputs land in, and the event after their copy (None on the CPU)."""
    n_real: int
    rows: torch.Tensor
    event: Optional[torch.cuda.Event]


class ChunkedStream:
    """Double-buffered chunked tracking over a host frame stream.

    ``feed`` takes one frame and returns the results drained so far;
    every C-th frame dispatches a chunk. ``flush`` runs the partial last
    chunk, drains everything and merges a solve in flight. ``state`` is
    the live tracking state (on CUDA, the graph's static buffers)."""

    def __init__(self, cfg, intr: Intrinsics, state: TrackState,
                 chunk: int = 8, use_mask: bool = False, seed: int = 0,
                 gray: bool = False, ba_mode: str = "off"):
        if ba_mode not in ("off", "async"):
            raise ValueError(f"unknown ba_mode {ba_mode!r}")
        for name, on in (("cull", cfg.cull.enabled),
                         ("loop", cfg.loop.enabled),
                         ("loop.reloc_after", cfg.loop.reloc_after > 0),
                         ("dense", cfg.dense.enabled)):
            if on:
                raise NotImplementedError(
                    f"config.{name} is not ported yet (ROADMAP.md)")
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
        arrays = self._host_frame(rgb, depth, mask)
        if self._staging is None:
            self._make_buffers(arrays)
        if self._n_host == 0 and self._staged[self._slot] is not None:
            # this set's last upload must be done before it is refilled
            self._staged[self._slot].synchronize()
        for buf, a in zip(self._staging[self._slot], arrays):
            buf[self._n_host].numpy()[...] = a
        self._n_host += 1
        if self._n_host == self.chunk:
            self._dispatch(self.chunk)
        # keep ONE chunk in flight: drain older results while the newest
        # chunk computes
        added = 0
        while len(self._inflight) > 1:
            added += self._collect(self._inflight.pop(0))
        self._kf_tick(added)
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
        if not self._cuda:
            st, outs = self._run(self._state, *(b[:n] for b in staged))
            assign_state(self._state, st)
            rows_host[:n].copy_(output_rows(outs))
            self._inflight.append(_Pending(n, rows_host, None))
        else:
            for dst, src in zip(self._dev_in, staged):
                dst[:n].copy_(src[:n], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            self._staged[self._slot] = ev
            if n == self.chunk:
                if self._graph is None:
                    self._capture()
                self._graph.replay()
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
            self._inflight.append(_Pending(n, rows_host, done))
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
        with graph_capture(graph):
            st, outs = self._run(self._state, *self._dev_in)
            self._rows_dev = output_rows(outs)
            assign_state(self._state, st)
        self._graph = graph

    def _collect(self, p: _Pending) -> int:
        """Read one chunk's outputs on the host; returns how many of its
        frames inserted a keyframe (the BA trigger)."""
        if p.event is not None:
            p.event.synchronize()
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
            added += d["added_kf"]
            self._frame += 1
        return added

    # --- chunk-late local BA ---------------------------------------------
    def _kf_tick(self, n_added: int, block: bool = False):
        """Merge a finished solve (or, with block, wait for it), then
        dispatch a new one if the drained frames inserted a keyframe.
        ``n_added`` counts insertions among the DRAINED frames, never
        read off the state of a chunk still in flight."""
        a = self._async
        if a is None:
            return
        if a.inflight is not None and (block or a.ready()):
            merged, record = a.merge(self._state.map)
            assign_state(self._state, self._state._replace(map=merged))
            self.ba_stats.append(record)
        if n_added and a.inflight is None:
            a.dispatch(self._state.map)
