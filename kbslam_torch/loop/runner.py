"""Host-side loop-closure runner of the per-frame shell (slam.SLAM) and
the chunked executor (streaming.ChunkedStream).

Port of kbslam/loop/runner.py, with its two scheduling rules:

- **Pending queue.** A probe must not run while an asynchronous local-BA
  solve is in flight: its merge would write pre-correction window poses
  over the corrected ring. Insertions queue their keyframe ordinals, and
  the queue drains on the first tick with no solve in flight. A probe of
  a keyframe that has since left its slot is a masked no-op
  (detect.make_loop_probe's ``query_id`` gate).
- **Ordinals counted on the host**, from the insertions the caller sees.

One fault of the reference is not copied: its runner numbers ordinals
from 0 whatever the map holds, so after a resume (or, on the chunked
path, after a relocalization insertion it is never told of) every probe
targets the wrong keyframe. Here the count starts at the map's
``num_kf``, read once on the host when the shell is built or its state
replaced (``start_at``), and both shells report every insertion.

Each probe's result comes to the host in one copy of a small packed
vector; a verified loop's close is dispatched on device tensors and its
stats come back in one more copy. On CUDA the probe and the close are
each replayed as one CUDA graph (``device.CapturedCall``), captured at
the first call for a map's shapes and shared by every runner of the
process with the same settings: both are launch-bound eagerly (a close
of a 64-keyframe ring is ~63k small kernels).
"""
from __future__ import annotations

from typing import List

import torch

from kbslam_torch.device import CapturedCall, tensor_leaves
from kbslam_torch.loop.closure import make_close_loop
from kbslam_torch.loop.detect import make_loop_probe


class _Replayed:
    """``fn`` eagerly on the CPU; on CUDA ``fn`` captured as one CUDA graph
    at its first call for each set of argument shapes and replayed after.
    The graphs are shared by every instance with the same ``key`` (the
    settings ``fn`` was made with); the outputs are the graph's own."""

    _graphs: dict = {}

    def __init__(self, fn, key):
        self.fn, self.key = fn, key

    def __call__(self, *args):
        leaves = list(tensor_leaves(args))
        if not leaves[0].is_cuda:
            return self.fn(*args)
        k = (self.key, leaves[0].device,
             tuple((t.shape, t.dtype) for t in leaves))
        graph = self._graphs.get(k)
        if graph is None:
            graph = self._graphs[k] = CapturedCall(self.fn, *args)
        return graph(*args)


class LoopCloser:
    """Probe/close scheduler. Callers report keyframe insertions with
    ``note_insertions`` and call ``tick`` whenever closing is safe to
    attempt; ``tick`` returns the (possibly corrected) state."""

    def __init__(self, cfg, intr, num_kf: int = 0):
        lc = cfg.loop
        self._probe = _Replayed(make_loop_probe(
            cfg, intr, word_bits=lc.word_bits,
            min_separation=lc.min_separation, score_min=lc.score_min,
            min_inliers=lc.min_inliers, max_trans_disc=lc.max_trans_disc,
            max_rot_disc_deg=lc.max_rot_disc_deg), ("probe", cfg, intr))
        self._close = _Replayed(
            make_close_loop(lc.max_iterations, lc.loop_weight),
            ("close", lc.max_iterations, lc.loop_weight))
        self.events: List[dict] = []
        self._pending: List[int] = []  # keyframe ordinals awaiting a probe
        self.start_at(num_kf)

    def start_at(self, num_kf: int):
        """Count ordinals on from a map that holds ``num_kf`` insertions
        (a new shell, or a state resumed from a checkpoint)."""
        self._num_insertions = int(num_kf)
        self._pending = []

    def note_insertions(self, n: int = 1):
        """Record n keyframe insertions."""
        for _ in range(n):
            self._num_insertions += 1
            self._pending.append(self._num_insertions)

    def tick(self, state, frame: int, ba_inflight):
        """Drain the pending probes unless an asynchronous solve is in
        flight (``ba_inflight`` not None); deferred ones retry on the next
        tick. Returns the state, corrected where a loop closed."""
        if ba_inflight is not None:
            return state
        while self._pending:
            ordinal = self._pending.pop(0)
            m = state.map
            dev = m.kf_id.device
            # device scalars made by fills, not host copies
            ord_t = torch.full((), ordinal, dtype=torch.int32, device=dev)
            qid = ord_t - 1
            qslot = torch.remainder(qid, m.capacity_kf)
            cand, cons = self._probe(m, qslot, qid, ord_t)
            ok, cand_id, score, inliers = torch.stack([
                cons.ok.to(torch.float64),
                m.kf_id.index_select(0, cand.slot.reshape(1).to(torch.int64))
                [0].to(torch.float64),
                cand.score.to(torch.float64),
                cons.num_inliers.to(torch.float64)]).cpu().tolist()
            if not ok:
                continue
            out, stats = self._close(m, cand.slot, qslot, cons.rel_q,
                                     cons.rel_t, cons.ok)
            # copies, out of a replayed graph's memory, into the live map
            state = state._replace(map=m._replace(
                kf_q=out.kf_q.clone(), kf_t=out.kf_t.clone(),
                mp_pos=out.mp_pos.clone()))
            init, final, accepted = torch.stack([
                stats.initial_cost.to(torch.float64),
                stats.final_cost.to(torch.float64),
                stats.accepted.to(torch.float64)]).cpu().tolist()
            self.events.append(dict(
                frame=frame, query_id=ordinal - 1, cand_id=int(cand_id),
                score=score, inliers=int(inliers), pg_initial_cost=init,
                pg_final_cost=final, pg_accepted=int(accepted)))
        return state
