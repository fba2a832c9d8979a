"""Merge the result of an asynchronous local BA into the live map.

Port of kbslam/ba/merge.py. Tracking keeps writing the live map while
the solve runs on a snapshot; the merge takes the solve's result only
where it is still valid:

- a window keyframe's pose and landmark references, where its ring slot
  still holds the same keyframe id (the ring may have wrapped);
- per reference entry, the result only where the snapshot held a live
  reference (tracking may have fused new ids into empty entries);
- landmark positions, for landmarks the snapshot window referenced that
  are still live in the current map (a slot reallocated meanwhile keeps
  its tracked position).

Pure selection: the merge is equal bit for bit to the reference's.
"""
from __future__ import annotations

import torch

from slambench.reference.mapping.state import MapState, scatter_rows, window_slots


def merge_ba_result(current: MapState, snapshot: MapState,
                    ba_result: MapState, cfg) -> MapState:
    P = current.capacity_mp
    slots, _ids, real = window_slots(snapshot, cfg.window)
    s64 = slots.to(torch.int64)

    same = real & (current.kf_id.index_select(0, s64)
                   == snapshot.kf_id.index_select(0, s64))
    kf_q = scatter_rows(current.kf_q, slots, same,
                        ba_result.kf_q.index_select(0, s64))
    kf_t = scatter_rows(current.kf_t, slots, same,
                        ba_result.kf_t.index_select(0, s64))
    # "had a reference" means live in the snapshot: after a landmark-ring
    # wrap a stale id is also >= 0, BA leaves it alone, and tracking may
    # have fused a fresh id into that entry while the solve ran
    snap_rows = snapshot.kf_mp.index_select(0, s64)          # [W, F]
    snap_live = (snap_rows >= 0) & (snap_rows >= snapshot.num_mp - P)
    merged_rows = torch.where(snap_live, ba_result.kf_mp.index_select(0, s64),
                              current.kf_mp.index_select(0, s64))
    kf_mp = scatter_rows(current.kf_mp, slots, same, merged_rows)

    # landmarks the snapshot window referenced, checked against the
    # current allocation counter
    flat = snap_rows.reshape(-1)
    flat_ok = (flat >= 0) & (flat >= current.num_mp - P)
    idx = torch.where(flat_ok, torch.remainder(flat, P), P).to(torch.int64)
    touched = torch.zeros(P + 1, dtype=torch.bool, device=flat.device)
    touched.index_fill_(0, idx, True)
    mp_pos = torch.where(touched[:P, None], ba_result.mp_pos, current.mp_pos)

    return current._replace(kf_q=kf_q, kf_t=kf_t, kf_mp=kf_mp, mp_pos=mp_pos)
