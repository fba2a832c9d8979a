"""Multi-stream tracking: N independent RGB-D streams in one program.

Port of kbslam/parallel/multistream.py (BASELINE.json config 4: 8
streams of 640x480 on one chip). As in the reference, every leaf of the
stream-batched ``TrackState`` carries a leading stream axis [S, ...], so
``state.map.num_kf`` is [S].

Over a process group (``group``, a ``parallel.dist.ShardGroup``), each
rank holds a contiguous block of S/W streams (``shard_streams``), the
counterpart of the reference's ``shard_streams`` onto a mesh, and runs
only those; ``gather_streams`` stacks the blocks back. As in the
reference, no collective runs while tracking: the streams share nothing.

The reference ``vmap``s the tracking step. The port cannot: the step
launches the describe kernel through ctypes and indexes by data, which
``torch.func.vmap`` does not run. Its one-card analogue keeps the
streams independent, which is vmap's meaning:

- on CUDA each stream's work (one step, or the scan's block of K steps
  with deferred insertion and then ``apply_pending``) is captured as its
  own CUDA graph, whose static state buffers are views of that stream's
  row of the stacked state; a call copies the frames into static input
  buffers, replays the S graphs on S side streams and joins them with
  events (``serial=True`` replays them one after another on the current
  stream instead, the yardstick of the overlap);
- on the CPU (only when the state lies there) the streams run one after
  another in a Python loop.

Stream i of frame f draws its RANSAC sets from ``hash_sampler(seed,
f * S + i)``, the counter the reference folds into its keys
(kbslam/parallel/multistream.py:124-127), with i the stream's global
index and S the global count: a rank's first stream is stream
rank * S/W, whatever block it runs in. The reference reads stream 0's
``frame_count`` for every stream; every stream's count advances once
per step, so each stream reads its own here, and no graph reads
another's row.

The insertion in the port's step is always the masked one, so the
reference's ``branchless_insert`` switch has no counterpart.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch

from kbslam_torch.device import graph_capture
from kbslam_torch.geom.camera import Intrinsics
from kbslam_torch.mapping.state import MapState
from kbslam_torch.parallel.dist import ShardGroup, block_tree, gather_tree
from kbslam_torch.pipeline import (PendingInsert, TrackOutput, TrackState,
                                   apply_pending, empty_pending, init_state,
                                   track_step)
from kbslam_torch.pnp.ransac import hash_sampler
from kbslam_torch.streaming import assign_state, clone_state


def batched_init_state(cfg, num_streams: int, device) -> TrackState:
    """S empty tracking states, stacked on a leading stream axis."""
    s = init_state(cfg, device)
    return TrackState(
        MapState(*(t.expand((num_streams,) + t.shape).clone()
                   for t in s.map)),
        *(t.expand((num_streams,) + t.shape).clone() for t in s[1:]))


def shard_streams(tree, group: ShardGroup):
    """This rank's block of S/W streams of a stream-batched tree (a
    ``TrackState``, ``TrackOutput`` or tensor), as copies; raises
    ``ValueError``, before any collective, when S is not divisible by the
    world size W."""
    return block_tree(tree, group)


def gather_streams(tree, group: ShardGroup):
    """Every rank's block of streams of a stream-batched tree, stacked in
    rank order: the whole batch on every rank."""
    return gather_tree(tree, group)


def _block(num_streams: int, group: Optional[ShardGroup]):
    """(first global stream index, streams) of this rank's block."""
    if group is None:
        return 0, num_streams
    return group.rows(num_streams, "streams")


def stream_state(state: TrackState, i: int) -> TrackState:
    """Stream i's state as views of row i of the stacked state."""
    return TrackState(MapState(*(t[i] for t in state.map)),
                      *(t[i] for t in state[1:]))


class _PerStream:
    """Runs ``body(i, state_i, *inputs) -> (new state_i, outputs_i)`` for
    every stream i of a stacked state, and writes each new state into
    row i. ``inputs`` are the call's stream-batched tensors.

    On CUDA the first call binds the given state as the storage of every
    later call (a call with another state copies it in first) and gives
    every stream a side stream of its own; on it, the body is warmed up
    on a copy of the stream's state and then captured. A graph bakes in
    the library workspaces (cuBLAS's) of the stream it was captured on,
    so graphs that replay at the same time must not share one. A call
    then replays the graphs. Outputs of a replay live in the graphs'
    memory until the next call."""

    def __init__(self, body: Callable, num_streams: int):
        self._body = body
        self.num_streams = num_streams
        self._state = None
        self._inputs: List[torch.Tensor] = []
        self._graphs: List[torch.cuda.CUDAGraph] = []
        self._outputs: list = []
        self._side: List[torch.cuda.Stream] = []
        self.replays = 0    # calls that replayed the graphs

    def __call__(self, state: TrackState, inputs, serial: bool = False):
        dev = state.pose_q.device
        if dev.type != "cuda":
            outs = []
            for i in range(self.num_streams):
                st_i = stream_state(state, i)
                new, out = self._body(i, st_i, *inputs)
                assign_state(st_i, new)
                outs.append(out)
            return state, outs
        if not self._graphs:
            self._capture(state, inputs)
        else:
            assign_state(self._state, state)
            for dst, src in zip(self._inputs, inputs):
                dst.copy_(src, non_blocking=True)
        self._replay(serial)
        self.replays += 1
        return self._state, self._outputs

    def _capture(self, state, inputs):
        dev = state.pose_q.device
        self._state = state
        self._inputs = [x.to(dev, copy=True) for x in inputs]
        cur = torch.cuda.current_stream(dev)
        self._side = [torch.cuda.Stream(dev) for _ in range(self.num_streams)]
        for i, side in enumerate(self._side):
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                self._body(i, clone_state(stream_state(state, i)),
                           *self._inputs)
            cur.wait_stream(side)
        for i, side in enumerate(self._side):
            graph = torch.cuda.CUDAGraph()
            with graph_capture(graph, stream=side):
                st_i = stream_state(state, i)
                new, out = self._body(i, st_i, *self._inputs)
                assign_state(st_i, new)
            self._graphs.append(graph)
            self._outputs.append(out)

    def _replay(self, serial: bool):
        if serial:
            for g in self._graphs:
                g.replay()
            return
        cur = torch.cuda.current_stream()
        start = torch.cuda.Event()
        start.record(cur)
        done = []
        for g, side in zip(self._graphs, self._side):
            side.wait_event(start)
            with torch.cuda.stream(side):
                g.replay()
            done.append(torch.cuda.Event())
            done[-1].record(side)
        for ev in done:
            cur.wait_event(ev)


def _stack_outputs(outs) -> TrackOutput:
    return TrackOutput(*(torch.stack(f) for f in zip(*outs)))


def _sampler(seed: int, st: TrackState, num_streams: int, i: int):
    return hash_sampler(seed, st.frame_count * num_streams + i)


def make_multistream_step(cfg, intr: Intrinsics, num_streams: int,
                          seed: int = 0, group: Optional[ShardGroup] = None):
    """``step(state[S], rgb [S, H, W, 3], depth [S, H, W], serial=False)
    -> (state[S], TrackOutput [S, ...])``: one tracking step of every
    stream, with immediate insertion. On CUDA the returned state is the
    step's own storage, which the next call updates in place (the
    reference donates its input state). Over a ``group``,
    ``num_streams`` is still the whole S, and the state, frames and
    outputs are this rank's block of S/W streams (``shard_streams``)."""
    first, count = _block(num_streams, group)

    def body(i, st, rgb, depth):
        return track_step(st, rgb[i], depth[i], None, intr, cfg,
                          _sampler(seed, st, num_streams, first + i))

    streams = _PerStream(body, count)

    def step(state, rgb, depth, serial: bool = False):
        state, outs = streams(state, (rgb, depth), serial)
        return state, _stack_outputs(outs)

    step.streams = streams
    return step


def make_multistream_scan(cfg, intr: Intrinsics, num_streams: int,
                          apply_every: int = 4, seed: int = 0,
                          group: Optional[ShardGroup] = None):
    """Deferred-insertion multistream tracking: ``run(state[S],
    rgb [T, S, H, W, 3], depth [T, S, H, W], serial=False) -> (state[S],
    num_inliers [T, S])``, T a multiple of ``apply_every`` = K.

    Each block of K frames tracks every stream with ``defer_insert``,
    keeps the newest flagged ``PendingInsert`` per stream (a fresh flag
    overwrites an applied one), and applies it once at the block's end:
    a keyframe lands up to K - 1 frames after the frame that flagged it,
    and the frames in between keep matching the previous keyframe. K may
    not exceed the policy's ``min_frame_gap``, so a block holds at most
    one flag per stream. On CUDA a stream's block is one graph. Over a
    ``group``, as ``make_multistream_step``: the frames, the state and
    the inlier counts [T, S/W] are this rank's streams."""
    if apply_every > cfg.policy.min_frame_gap:
        raise ValueError("apply_every must not exceed min_frame_gap: a "
                         "second flag could overwrite an unapplied pending "
                         "insertion")
    K = int(apply_every)
    first, count = _block(num_streams, group)

    def body(i, st, rgb, depth):
        pend, ninl = empty_pending(cfg, st.pose_q.device), []
        for k in range(K):
            st, out, new = track_step(st, rgb[k, i], depth[k, i], None, intr,
                                      cfg, _sampler(seed, st, num_streams,
                                                    first + i),
                                      defer_insert=True)
            pend = PendingInsert(*(torch.where(new.do, n, o)
                                   for n, o in zip(new, pend)))
            ninl.append(out.num_inliers)
        st = st._replace(map=apply_pending(st.map, pend, intr))
        return st, torch.stack(ninl)

    streams = _PerStream(body, count)

    def run(state, rgb, depth, serial: bool = False):
        T = rgb.shape[0]
        if T % K:
            raise ValueError(f"{T} frames are not a multiple of "
                             f"apply_every={K}")
        ninl = []
        for b in range(0, T, K):
            state, outs = streams(state, (rgb[b:b + K], depth[b:b + K]),
                                  serial)
            ninl.append(torch.stack(outs, dim=1))          # [K, S]
        return state, torch.cat(ninl)

    run.streams = streams
    return run
