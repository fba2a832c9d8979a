"""Multi-stream tracking: N independent RGB-D streams in one program.

Port of kbslam/parallel/multistream.py (BASELINE.json config 4: 8
streams of 640x480 on one chip). As in the reference, every leaf of the
stream-batched ``TrackState`` carries a leading stream axis [S, ...], so
``state.map.num_kf`` is [S].

The reference ``vmap``s the tracking step; the port runs its batched
form, ``pipeline.track_step_batched``, whose every stage works on all S
streams at once (one describe launch over the S x F keypoints, a batched
Hamming product, S x K RANSAC hypotheses, per-stream ring writes), and
``apply_pending_batched`` for the deferred insertion:

- on CUDA one step (or one block of K steps with deferred insertion and
  then ``apply_pending_batched``) is one CUDA graph over the whole
  stacked state (``device.LiveGraphs``), captured at first use on a
  stream of its own; a call copies the frames into static input buffers
  and replays it;
- on the CPU (only when the state lies there) the same batched
  functions run eagerly.

Over a process group (``group``, a ``parallel.dist.ShardGroup``), each
rank holds a contiguous block of S/W streams (``shard_streams``), the
counterpart of the reference's ``shard_streams`` onto a mesh, and runs
them as one batched program; ``gather_streams`` stacks the blocks back.
As in the reference, no collective runs while tracking: the streams
share nothing.

Stream i of frame f draws its RANSAC sets from ``hash_sampler(seed,
f * S + i)``, the counter the reference folds into its keys
(kbslam/parallel/multistream.py:124-127), with i the stream's global
index and S the global count: a rank's first stream is stream
rank * S/W, whatever block it runs in. The reference reads stream 0's
``frame_count`` for every stream; every stream's count advances once
per step, so each stream reads its own here.

``make_perstream_step`` and ``make_perstream_scan`` run the streams one
``track_step`` each instead (one CUDA graph per stream, replayed on side
streams or serially): the yardstick the batched program is measured and
checked against; nothing picks them by itself.

The insertion in the port's step is always the masked one, so the
reference's ``branchless_insert`` switch has no counterpart.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch

from kbslam_torch.device import LiveGraphs, graph_capture, replay
from kbslam_torch.geom.camera import Intrinsics
from kbslam_torch.mapping.state import MapState
from kbslam_torch.parallel.dist import ShardGroup, block_tree, gather_tree
from kbslam_torch.pipeline import (PendingInsert, TrackOutput, TrackState,
                                   apply_pending, apply_pending_batched,
                                   empty_pending, init_state, track_step,
                                   track_step_batched)
from kbslam_torch.pnp.ransac import hash_sampler
from kbslam_torch.streaming import assign_state, clone_state
from kbslam_torch.utils import profiling


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


class _Batched:
    """Runs ``body(state, *inputs) -> (new state, outputs)`` on a
    stream-batched state and writes the new state into it.

    On CUDA the first call binds the given state as the storage of every
    later call (a call with another state copies it in first) and copies
    the inputs into static buffers; ``body`` is then one CUDA graph on
    them (``LiveGraphs``: a warm-up on copies, then the capture, both on
    a stream of its own), which every call replays. Outputs are returned
    as copies. On the CPU ``body`` runs eagerly on the given state.

    A call is traced (``utils.profiling``): ``multistream.step``, with the
    index of the call (``calls`` before it), and inside it on CUDA
    ``multistream.upload`` (the inputs into the static buffers) and
    ``multistream.replay`` (the replay and the outputs' copies)."""

    def __init__(self, body: Callable, name: str):
        self._body = body
        self._name = name
        self._state = None
        self._inputs: List[torch.Tensor] = []
        self.graphs: Optional[LiveGraphs] = None
        self.calls = 0

    @property
    def replays(self) -> int:
        return 0 if self.graphs is None else self.graphs.replays

    def _run(self, state, *inputs):
        new, out = self._body(state, *inputs)
        assign_state(state, new)
        return out

    def __call__(self, state: TrackState, inputs):
        with profiling.span("multistream.step", self.calls):
            self.calls += 1
            return self._call(state, inputs)

    def _call(self, state: TrackState, inputs):
        dev = state.pose_q.device
        if dev.type != "cuda":
            return state, self._run(state, *inputs)
        with profiling.span("multistream.upload"):
            if self.graphs is None:
                self._state = state
                self._inputs = [x.to(dev, copy=True) for x in inputs]
                self.graphs = LiveGraphs(self._run,
                                         stream=torch.cuda.Stream(dev),
                                         name=self._name)
            else:
                assign_state(self._state, state)
                for dst, src in zip(self._inputs, inputs):
                    dst.copy_(src, non_blocking=True)
        with profiling.span("multistream.replay"):
            out = self.graphs(self._state, *self._inputs)
            copies = [t.clone() for t in out]
        return self._state, (type(out)(*copies) if hasattr(out, "_fields")
                             else tuple(copies))


def _counters(st: TrackState, num_streams: int, first: int) -> torch.Tensor:
    """Each stream's RANSAC counter, frame * S + its global index, [S/W]."""
    count = st.frame_count.shape[0]
    return st.frame_count * num_streams + (
        first + torch.arange(count, dtype=torch.int32,
                             device=st.frame_count.device))


def make_multistream_step(cfg, intr: Intrinsics, num_streams: int,
                          seed: int = 0, group: Optional[ShardGroup] = None,
                          sampler_for=None):
    """``step(state[S], rgb [S, H, W, 3], depth [S, H, W]) -> (state[S],
    TrackOutput [S, ...])``: one tracking step of every stream, with
    immediate insertion, as one batched program. On CUDA the returned
    state is the step's own storage, which the next call updates in
    place (the reference donates its input state). Over a ``group``,
    ``num_streams`` is still the whole S, and the state, frames and
    outputs are this rank's block of S/W streams (``shard_streams``).
    ``sampler_for(counters)`` replaces the batched ``hash_sampler`` of
    the streams' counters [S] (tests inject the reference's sets; it may
    read them on the host, so only on the CPU)."""
    first, _ = _block(num_streams, group)

    def body(st, rgb, depth):
        c = _counters(st, num_streams, first)
        sampler = (hash_sampler(seed, c) if sampler_for is None
                   else sampler_for(c))
        return track_step_batched(st, rgb, depth, None, intr, cfg, sampler)

    program = _Batched(body, "multistream_step")

    def step(state, rgb, depth):
        return program(state, (rgb, depth))

    step.program = program
    return step


def make_multistream_scan(cfg, intr: Intrinsics, num_streams: int,
                          apply_every: int = 4, seed: int = 0,
                          group: Optional[ShardGroup] = None,
                          sampler_for=None):
    """Deferred-insertion multistream tracking: ``run(state[S],
    rgb [T, S, H, W, 3], depth [T, S, H, W]) -> (state[S],
    num_inliers [T, S])``, T a multiple of ``apply_every`` = K.

    Each block of K frames tracks every stream with ``defer_insert``,
    keeps the newest flagged ``PendingInsert`` per stream (a fresh flag
    overwrites an applied one), and applies them once at the block's
    end: a keyframe lands up to K - 1 frames after the frame that
    flagged it, and the frames in between keep matching the previous
    keyframe. K may not exceed the policy's ``min_frame_gap``, so a
    block holds at most one flag per stream. On CUDA a block is one
    graph. Over a ``group`` and with ``sampler_for``, as
    ``make_multistream_step``: the frames, the state and the inlier
    counts [T, S/W] are this rank's streams."""
    K = _check_block(cfg, apply_every)
    first, count = _block(num_streams, group)

    def body(st, rgb, depth):
        pend = empty_pending(cfg, st.pose_q.device, (count,))
        ninl = []
        for k in range(K):
            c = _counters(st, num_streams, first)
            sampler = (hash_sampler(seed, c) if sampler_for is None
                       else sampler_for(c))
            st, out, new = track_step_batched(st, rgb[k], depth[k], None,
                                              intr, cfg, sampler,
                                              defer_insert=True)
            pend = PendingInsert(*(
                torch.where(new.do.reshape((-1,) + (1,) * (n.ndim - 1)), n, o)
                for n, o in zip(new, pend)))
            ninl.append(out.num_inliers)
        st = st._replace(map=apply_pending_batched(st.map, pend, intr))
        return st, (torch.stack(ninl),)

    program = _Batched(body, "multistream_scan")

    def run(state, rgb, depth):
        ninl = []
        for b in range(0, _frames(rgb, K), K):
            state, (n,) = program(state, (rgb[b:b + K], depth[b:b + K]))
            ninl.append(n)                                   # [K, S]
        return state, torch.cat(ninl)

    run.program = program
    return run


def _check_block(cfg, apply_every: int) -> int:
    if apply_every > cfg.policy.min_frame_gap:
        raise ValueError("apply_every must not exceed min_frame_gap: a "
                         "second flag could overwrite an unapplied pending "
                         "insertion")
    return int(apply_every)


def _frames(rgb, K: int) -> int:
    T = rgb.shape[0]
    if T % K:
        raise ValueError(f"{T} frames are not a multiple of "
                         f"apply_every={K}")
    return T


# --- the yardstick: one single-stream program per stream ---------------------


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
            with graph_capture(graph, stream=side, name="perstream"):
                st_i = stream_state(state, i)
                new, out = self._body(i, st_i, *self._inputs)
                assign_state(st_i, new)
            self._graphs.append(graph)
            self._outputs.append(out)

    def _replay(self, serial: bool):
        if serial:
            for g in self._graphs:
                replay(g)
            return
        cur = torch.cuda.current_stream()
        start = torch.cuda.Event()
        start.record(cur)
        done = []
        for g, side in zip(self._graphs, self._side):
            side.wait_event(start)
            with torch.cuda.stream(side):
                replay(g)
            done.append(torch.cuda.Event())
            done[-1].record(side)
        for ev in done:
            cur.wait_event(ev)


def _stack_outputs(outs) -> TrackOutput:
    return TrackOutput(*(torch.stack(f) for f in zip(*outs)))


def _sampler(seed: int, st: TrackState, num_streams: int, i: int):
    return hash_sampler(seed, st.frame_count * num_streams + i)


def make_perstream_step(cfg, intr: Intrinsics, num_streams: int,
                        seed: int = 0, group: Optional[ShardGroup] = None):
    """``make_multistream_step``'s function as one ``track_step`` per
    stream: ``step(state[S], rgb, depth, serial=False)``. On CUDA each
    stream is its own CUDA graph on a side stream of its own (replayed
    one after another on the current stream with ``serial``). The same
    draws as the batched step, so each stream's result is its
    single-stream run's."""
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


def make_perstream_scan(cfg, intr: Intrinsics, num_streams: int,
                        apply_every: int = 4, seed: int = 0,
                        group: Optional[ShardGroup] = None):
    """``make_multistream_scan``'s function as one program per stream
    (see ``make_perstream_step``): ``run(state[S], rgb, depth,
    serial=False)``."""
    K = _check_block(cfg, apply_every)
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
        ninl = []
        for b in range(0, _frames(rgb, K), K):
            state, outs = streams(state, (rgb[b:b + K], depth[b:b + K]),
                                  serial)
            ninl.append(torch.stack(outs, dim=1))          # [K, S]
        return state, torch.cat(ninl)

    run.streams = streams
    return run
