"""Sliding-window local bundle adjustment: build, solve, write back.

Port of kbslam/ba/local_ba.py. ``local_ba`` is a function from a map to
a new map: its writeback builds new ``kf_q``, ``kf_t``, ``mp_pos`` and
``kf_mp`` tensors and leaves the input's untouched, so a snapshot handed
to an asynchronous solve never shares storage with the live map that
the tracking step keeps writing in place.

After the solve a window landmark is pruned when it has fewer than 2
window observations, fewer than 2 gated-in observations, or a gated-in
share below 0.4; pruning clears the window keyframes' references only.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from kbslam_torch.ba.compact import compact_problem
from kbslam_torch.ba.compact_lm import solve_window_compact
from kbslam_torch.ba.merge import merge_ba_result
from kbslam_torch.ba.problem import build_problem
from kbslam_torch.device import CapturedCall
from kbslam_torch.geom.camera import Intrinsics
from kbslam_torch.mapping.state import MapState, device_copy, scatter_rows


class BAStats(NamedTuple):
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    iterations: torch.Tensor
    accepted: torch.Tensor     # LM steps that decreased the cost
    num_pruned: torch.Tensor


def stats_vector(stats: BAStats) -> torch.Tensor:
    """The five stats as one float64 vector (one copy to the host)."""
    return torch.stack([x.to(torch.float64) for x in stats])


def stats_record(v, wall_ms=None) -> dict:
    """The host record of one solve from its ``stats_vector``."""
    return dict(initial_cost=float(v[0]), final_cost=float(v[1]),
                iterations=int(v[2]), accepted=int(v[3]),
                num_pruned=int(v[4]), wall_ms=wall_ms)


def local_ba(state: MapState, intr: Intrinsics,
             cfg) -> Tuple[MapState, BAStats]:
    prob = build_problem(state, intr, cfg)
    cp = compact_problem(prob, state.mp_pos, cfg.compact_obs,
                         cfg.compact_landmarks)
    sol = solve_window_compact(prob, cp, intr, cfg)

    ran = state.num_kf >= 2    # nothing to optimize below two keyframes

    # --- pose and point writeback; padded window slots write nothing ------
    rows = prob.real & ran
    kf_q = scatter_rows(state.kf_q, prob.slots, rows, sol.cam_q)
    kf_t = scatter_rows(state.kf_t, prob.slots, rows, sol.cam_t)
    mp_pos = scatter_rows(state.mp_pos, cp.uniq_global, cp.l_valid & ran,
                          sol.Xc)

    # --- pruning ------------------------------------------------------------
    total = prob.total_obs
    inl = prob.inlier_obs
    ratio = inl.to(torch.float32) / torch.clamp(total.to(torch.float32),
                                                min=1.0)
    drop = prob.touched & (
        (total < cfg.prune_min_obs)
        | (inl < cfg.prune_min_inlier_kfs)
        | (ratio < cfg.prune_min_inlier_ratio)
    ) & ran

    window_rows = state.kf_mp.index_select(0, prob.slots.to(torch.int64))
    live = state.mp_ref_live(window_rows)
    slot = state.mp_ref_slot(window_rows).reshape(-1).to(torch.int64)
    dropped_here = drop.index_select(0, slot).reshape(live.shape) & live
    new_rows = torch.where(dropped_here, -1, window_rows)
    kf_mp = scatter_rows(state.kf_mp, prob.slots, rows, new_rows)

    stats = BAStats(
        initial_cost=sol.initial_cost,
        final_cost=sol.final_cost,
        iterations=sol.iterations,
        accepted=sol.accepted,
        num_pruned=torch.sum(drop.to(torch.int32)),
    )
    return state._replace(kf_q=kf_q, kf_t=kf_t, mp_pos=mp_pos,
                          kf_mp=kf_mp), stats


def make_local_ba(cfg, intr: Intrinsics):
    """``map -> (new map, BAStats)`` with the configuration bound."""
    return lambda m: local_ba(m, intr, cfg)


class GraphedLocalBA:
    """``local_ba`` captured as one CUDA graph for one map shape
    (``device.CapturedCall``).

    The solve makes no host sync, so it captures as it is. ``snapshot``
    copies a live map into the graph's static input on the current
    stream; ``solve`` replays the graph on the current stream (the
    caller may make that a side stream that waits for the copy). The
    result map and the stats live in the graph's memory and stay valid
    until the next replay, so read or copy them first. A capture that
    fails raises; nothing falls back to the eager solve."""

    def __init__(self, cfg, intr: Intrinsics, like: MapState):
        if not like.kf_q.is_cuda:
            raise ValueError("GraphedLocalBA needs a map on a CUDA device")

        def solve(m):
            result, stats = local_ba(m, intr, cfg)
            return result, stats, stats_vector(stats)

        self._captured = CapturedCall(solve, like)
        self.input = self._captured.inputs[0]
        self.result, self.stats, self.stats_vector = self._captured.outputs

    def snapshot(self, live: MapState) -> MapState:
        self._captured.load(live)
        return self.input

    def solve(self) -> Tuple[MapState, BAStats]:
        self._captured.graph.replay()
        return self.result, self.stats


class InFlightSolve(NamedTuple):
    """An asynchronous solve: its snapshot and result, its stats in host
    memory, and the event recorded after it on the side stream (None on
    the CPU). The stats are valid once the event has completed."""
    snapshot: MapState
    result: MapState
    stats_host: torch.Tensor
    event: Optional[torch.cuda.Event]


class AsyncLocalBA:
    """At most one local-BA solve in flight beside tracking, for
    ``slam.SLAM`` and ``streaming.ChunkedStream`` alike.

    - On CUDA, ``dispatch`` copies the live map into the static input of
      a ``GraphedLocalBA`` (captured at the first dispatch) on the
      current stream; a side stream waits for that copy, replays the
      graph, copies the stats to pinned host memory and records an
      event. The graph's input, result and stats stay as they are until
      the next dispatch, which comes after the merge, and the graph owns
      their memory, so no tensor crosses the streams without an order.
    - On the CPU (only when the map lies there) the solve runs at
      dispatch, on a copy of the map.

    ``ready`` polls the event and never blocks. ``merge`` makes the
    current stream wait for the solve, merges its result into the live
    map it is given (``ba.merge``), waits on the host for the stats and
    returns the new map and the solve's record."""

    def __init__(self, cfg, intr: Intrinsics):
        self._cfg, self._intr = cfg, intr
        self._graph: Optional[GraphedLocalBA] = None
        self._stream = None
        self._stats_host = None
        self.inflight: Optional[InFlightSolve] = None

    def dispatch(self, live: MapState) -> None:
        if self.inflight is not None:
            raise RuntimeError("a local-BA solve is already in flight")
        if not live.kf_q.is_cuda:
            snap = device_copy(live)
            result, stats = local_ba(snap, self._intr, self._cfg)
            self.inflight = InFlightSolve(snap, result, stats_vector(stats),
                                          None)
            return
        dev = live.kf_q.device
        if self._graph is None:
            self._graph = GraphedLocalBA(self._cfg, self._intr, live)
            self._stream = torch.cuda.Stream(dev)
            self._stats_host = torch.empty(len(BAStats._fields),
                                           dtype=torch.float64,
                                           pin_memory=True)
        g, side = self._graph, self._stream
        snap = g.snapshot(live)                    # on the current stream
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            result, _ = g.solve()
            self._stats_host.copy_(g.stats_vector, non_blocking=True)
            event = torch.cuda.Event()
            event.record(side)
        self.inflight = InFlightSolve(snap, result, self._stats_host, event)

    def ready(self) -> bool:
        f = self.inflight
        return f is not None and (f.event is None or f.event.query())

    def merge(self, live: MapState) -> Tuple[MapState, dict]:
        """The solve in flight merged into ``live`` (it waits for the
        solve if it has not finished), and its stats record."""
        f = self.inflight
        if f.event is not None:
            torch.cuda.current_stream(live.kf_q.device).wait_event(f.event)
        merged = merge_ba_result(live, f.snapshot, f.result, self._cfg)
        if f.event is not None:
            f.event.synchronize()
        self.inflight = None
        return merged, stats_record(f.stats_host.numpy())
