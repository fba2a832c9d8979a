"""Fixed-capacity map state: a keyframe ring and a landmark ring.

Port of kbslam/mapping/state.py, with the same field names and the same
monotone-id liveness rule. Mutations are masked, so a step never needs
the host to decide whether to write:

- A row write (a keyframe slot) reads the slot's old row and writes back
  ``where(do, new, old)``; ``do=False`` writes the old row unchanged.
- A scatter of many rows (landmarks, landmark ids) sends lanes that do
  not take part to a spare row past the end, which is then cut off:
  ``index_put_`` does not drop out-of-range indices as JAX's
  ``mode="drop"`` does.
- Where two lanes target one slot, the last lane wins, as JAX's CPU
  scatter gives; ``index_put_`` on CUDA leaves such a winner undefined,
  so losing lanes are sent to the spare row first.

The functions update the map's tensors in place and return the state:
the reference's jitted step donates the old state's buffers
(kbslam/pipeline.py:432), so no caller keeps using them.

The ``*_batched`` functions do the same on S maps stacked on a leading
stream axis (the multistream step), each stream with its own ring slot
[S]: rows are read and written through flat offsets ``s * capacity +
slot`` on the device (``index_select``/``index_copy_``), never a host
index, and each stream scatters into its own spare row, its last lane
winning.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from slambench.reference.geom.se3 import SE3

NO_MP = -1


class MapState(NamedTuple):
    # keyframe ring (capacity M = max_keyframes)
    kf_q: torch.Tensor         # [M, 4] T_wc rotation
    kf_t: torch.Tensor         # [M, 3]
    kf_kp_xy: torch.Tensor     # [M, F, 2] keypoint pixel coords (level 0)
    kf_kp_depth: torch.Tensor  # [M, F] metric depth at keypoint (0 = missing)
    kf_desc: torch.Tensor      # [M, F, 256] uint8 descriptor bits
    kf_kp_valid: torch.Tensor  # [M, F] bool
    kf_mp: torch.Tensor        # [M, F] int32 monotone landmark id (-1 empty);
    #   storage slot = id % P; live iff id >= num_mp - P
    kf_id: torch.Tensor        # [M] int32 global keyframe id (-1 = empty)
    num_kf: torch.Tensor       # [] int32 monotone insertion counter
    # landmarks (capacity P = max_map_points)
    mp_pos: torch.Tensor       # [P, 3] world positions
    mp_valid: torch.Tensor     # [P] bool
    num_mp: torch.Tensor       # [] int32 monotone allocation counter

    @property
    def capacity_kf(self) -> int:
        return self.kf_q.shape[-2]

    @property
    def capacity_mp(self) -> int:
        return self.mp_pos.shape[-2]

    def last_slot(self) -> torch.Tensor:
        """Ring slot of the most recent keyframe (undefined if empty);
        [S] for S stacked maps."""
        return torch.remainder(self.num_kf - 1, self.capacity_kf)

    def is_empty(self) -> torch.Tensor:
        return self.num_kf == 0

    def last_kf_pose(self) -> SE3:
        s = self.last_slot()
        return SE3(take_row(self.kf_q, s), take_row(self.kf_t, s))

    def mp_ref_live(self, ids: torch.Tensor) -> torch.Tensor:
        """True where a kf_mp entry still points at a live landmark."""
        return (ids >= 0) & (ids >= self.num_mp - self.capacity_mp)

    def mp_ref_slot(self, ids: torch.Tensor) -> torch.Tensor:
        """Storage slot of a kf_mp entry (floor modulo, as jnp's %)."""
        return torch.remainder(torch.clamp(ids, min=0), self.capacity_mp)


def device_copy(state: MapState) -> MapState:
    """A map whose every tensor is a fresh copy (``clone``): the
    snapshot an asynchronous solve reads, which the step's in-place
    writes to the live map cannot reach."""
    return MapState(*(t.clone() for t in state))


def empty_map(map_cfg, orb_cfg, device) -> MapState:
    m, f, p = map_cfg.max_keyframes, orb_cfg.max_features, map_cfg.max_map_points
    i32 = torch.int32
    return MapState(
        kf_q=torch.tensor([1.0, 0, 0, 0], device=device).repeat(m, 1),
        kf_t=torch.zeros((m, 3), device=device),
        kf_kp_xy=torch.zeros((m, f, 2), device=device),
        kf_kp_depth=torch.zeros((m, f), device=device),
        kf_desc=torch.zeros((m, f, 256), dtype=torch.uint8, device=device),
        kf_kp_valid=torch.zeros((m, f), dtype=torch.bool, device=device),
        kf_mp=torch.full((m, f), NO_MP, dtype=i32, device=device),
        kf_id=torch.full((m,), -1, dtype=i32, device=device),
        num_kf=torch.zeros((), dtype=i32, device=device),
        mp_pos=torch.zeros((p, 3), device=device),
        mp_valid=torch.zeros((p,), dtype=torch.bool, device=device),
        num_mp=torch.zeros((), dtype=i32, device=device),
    )


def take_row(arr: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """arr[slot] for a 0-d device tensor ``slot``, as a copy. Plain
    indexing with a 0-d tensor reads it on the host (a device sync)."""
    return arr.index_select(0, slot.reshape(1).to(torch.int64))[0]


def _write_row(arr: torch.Tensor, slot: torch.Tensor, row: torch.Tensor,
               do: Optional[torch.Tensor]) -> torch.Tensor:
    """arr[slot] = row when do (or do is None), in place; slot is a
    0-d tensor inside the ring."""
    idx = slot.reshape(1).to(torch.int64)
    row = row.to(arr.dtype).expand(arr.shape[1:])
    if do is not None:
        row = torch.where(do, row, take_row(arr, slot))
    return arr.index_copy_(0, idx, row[None])


def _last_lane_wins(target: torch.Tensor, active: torch.Tensor,
                    size: int) -> torch.Tensor:
    """Scatter index per lane: ``target`` for the last active lane of
    each target, ``size`` (a spare row) for every other lane."""
    lanes = torch.arange(target.shape[0], device=target.device)
    tgt = torch.where(active, target.to(torch.int64), size)
    last = torch.full((size + 1,), -1, dtype=torch.int64, device=target.device)
    last.scatter_reduce_(0, tgt, lanes, reduce="amax")
    return torch.where(active & (last[tgt] == lanes), tgt, size)


def scatter_rows(arr: torch.Tensor, target: torch.Tensor,
                 active: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """arr[target[i]] = values[i] for active lanes, last lane winning;
    returns a new tensor (one spare row is appended and cut off)."""
    size = arr.shape[0]
    idx = _last_lane_wins(target, active, size)
    spare = arr.new_zeros((1,) + arr.shape[1:])
    buf = torch.cat([arr, spare])
    buf.index_put_((idx,), values.to(arr.dtype).expand(
        (idx.shape[0],) + arr.shape[1:]))
    return buf[:size]


def insert_keyframe(state: MapState, feats, depth_at_kp: torch.Tensor,
                    pose: SE3, do: Optional[torch.Tensor] = None) -> MapState:
    """Map::AddKeyframe: write the new keyframe into the next ring slot
    (its landmark slots start empty). ``do`` (0-d bool) gates the write
    without a branch; False leaves the state unchanged."""
    slot = torch.remainder(state.num_kf, state.capacity_kf)
    inc = 1 if do is None else do.to(state.num_kf.dtype)
    no_mp = torch.full_like(state.kf_mp[0], NO_MP)
    return state._replace(
        kf_q=_write_row(state.kf_q, slot, pose.q, do),
        kf_t=_write_row(state.kf_t, slot, pose.t, do),
        kf_kp_xy=_write_row(state.kf_kp_xy, slot, feats.xy, do),
        kf_kp_depth=_write_row(state.kf_kp_depth, slot, depth_at_kp, do),
        kf_desc=_write_row(state.kf_desc, slot, feats.desc, do),
        kf_kp_valid=_write_row(state.kf_kp_valid, slot, feats.valid, do),
        kf_mp=_write_row(state.kf_mp, slot, no_mp, do),
        kf_id=_write_row(state.kf_id, slot, state.num_kf, do),
        num_kf=state.num_kf + inc,
    )


def create_map_points(state: MapState, match, intr_fx, intr_fy, intr_cx,
                      intr_cy, do: Optional[torch.Tensor] = None,
                      prev_slot: Optional[torch.Tensor] = None) -> MapState:
    """Map::CreateMapPoints as masked scatters. For each ratio-test match
    between the previous keyframe (query q) and the just-inserted one
    (train match.best_idx[q]): an empty (or stale) previous slot
    allocates a new landmark at the previous keyframe's unprojected
    keypoint; a live one shares its id into the current slot."""
    m = state.capacity_kf
    if prev_slot is None:
        prev_slot = torch.remainder(state.num_kf - 2, m)
    curr_slot = torch.remainder(state.num_kf - 1, m)
    matched = match.is_match if do is None else match.is_match & do
    t_idx = match.best_idx

    prev_mp = take_row(state.kf_mp, prev_slot)            # [F]
    # a stale reference (slot reused after the ring wrapped) counts as
    # empty: the match allocates a fresh landmark
    prev_live = state.mp_ref_live(prev_mp)
    needs_new = matched & ~prev_live

    # contiguous monotone ids; storage wraps at id % P
    offset = torch.cumsum(needs_new.to(torch.int32), dim=0) - 1
    new_id = (state.num_mp + offset).to(torch.int32)
    n_new = torch.sum(needs_new, dtype=torch.int32)   # num_mp stays int32

    # world position from the previous keyframe's depth (Map.cpp:29-44)
    xy = take_row(state.kf_kp_xy, prev_slot)
    z = take_row(state.kf_kp_depth, prev_slot)
    x = (xy[:, 0] - intr_cx) * z / intr_fx
    y = (xy[:, 1] - intr_cy) * z / intr_fy
    prev_pose = SE3(take_row(state.kf_q, prev_slot),
                    take_row(state.kf_t, prev_slot))
    p_world = prev_pose.apply(torch.stack([x, y, z], dim=-1))  # [F, 3]

    P = state.capacity_mp
    mp_slot = torch.remainder(new_id, P)
    mp_pos = scatter_rows(state.mp_pos, mp_slot, needs_new, p_world)
    mp_valid = scatter_rows(state.mp_valid, mp_slot, needs_new,
                            torch.ones_like(needs_new))

    # previous keyframe gains the new ids; the current one gains
    # new-or-shared ids; unmatched stale entries are scrubbed to empty
    no_mp = torch.full_like(prev_mp, NO_MP)
    prev_mp_new = torch.where(needs_new, new_id,
                              torch.where(prev_live, prev_mp, no_mp))
    curr_mp_new = scatter_rows(take_row(state.kf_mp, curr_slot), t_idx, matched,
                               prev_mp_new)

    kf_mp = _write_row(state.kf_mp, prev_slot, prev_mp_new, do)
    kf_mp = _write_row(kf_mp, curr_slot, curr_mp_new, do)
    return state._replace(kf_mp=kf_mp, mp_pos=mp_pos, mp_valid=mp_valid,
                          num_mp=state.num_mp + n_new)


def window_slots(state: MapState, window: int):
    """(ring slots, keyframe ids, real mask) of the last ``window``
    keyframes, oldest first, padded with the oldest available."""
    n = state.num_kf
    rel = torch.arange(-window, 0, dtype=torch.int32, device=n.device)
    ids = torch.clamp(rel + n, min=0)
    return torch.remainder(ids, state.capacity_kf), ids, (rel + n) >= 0


# --- S maps stacked on a leading stream axis --------------------------------


def _flat_rows(arr: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Row ``s * capacity + slot[s]`` of the flattened [S * capacity, ...]
    ``arr`` for every stream s."""
    S, cap = arr.shape[:2]
    return (slot.to(torch.int64)
            + torch.arange(S, device=slot.device) * cap)


def take_rows(arr: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """[S, M, ...] and ring slots [S] -> each stream's row [S, ...], as a
    copy (``take_row`` per stream, in one ``index_select``)."""
    flat = arr.reshape((-1,) + arr.shape[2:])
    return flat.index_select(0, _flat_rows(arr, slot))


def _write_rows(arr: torch.Tensor, slot: torch.Tensor, row: torch.Tensor,
                do: torch.Tensor) -> torch.Tensor:
    """arr[s, slot[s]] = row[s] where do[s], in place (``_write_row``
    per stream); ``arr`` must be contiguous."""
    row = row.to(arr.dtype).expand(arr.shape[:1] + arr.shape[2:])
    keep = do.reshape(do.shape + (1,) * (row.ndim - 1))
    row = torch.where(keep, row, take_rows(arr, slot))
    arr.view((-1,) + arr.shape[2:]).index_copy_(0, _flat_rows(arr, slot),
                                                 row)
    return arr


def scatter_rows_batched(arr: torch.Tensor, target: torch.Tensor,
                         active: torch.Tensor,
                         values: torch.Tensor) -> torch.Tensor:
    """``scatter_rows`` per stream: arr [S, P, ...], target and active
    [S, F], values [S, F, ...]; each stream's last active lane wins on a
    target of its own, and its other lanes go to its own spare row.
    Returns a new tensor."""
    S, size = arr.shape[:2]
    first = torch.arange(S, device=target.device)[:, None] * (size + 1)
    tgt = torch.where(active, target.to(torch.int64), size) + first
    lanes = torch.arange(tgt.numel(), device=target.device).reshape(
        tgt.shape)
    last = torch.full((S * (size + 1),), -1, dtype=torch.int64,
                      device=target.device)
    last.scatter_reduce_(0, tgt.reshape(-1), lanes.reshape(-1),
                         reduce="amax")
    idx = torch.where(active & (last[tgt] == lanes), tgt, first + size)
    rest = arr.shape[2:]
    buf = torch.cat([arr, arr.new_zeros((S, 1) + rest)], dim=1)
    buf.view((-1,) + rest).index_put_(
        (idx.reshape(-1),),
        values.to(arr.dtype).expand(tgt.shape + rest).reshape((-1,) + rest))
    return buf[:, :size]


def insert_keyframe_batched(state: MapState, feats, depth_at_kp: torch.Tensor,
                            pose: SE3, do: torch.Tensor) -> MapState:
    """``insert_keyframe`` on S stacked maps: stream s writes its frame
    into its next ring slot where do[s]."""
    slot = torch.remainder(state.num_kf, state.capacity_kf)
    no_mp = torch.full_like(state.kf_mp[:, 0], NO_MP)
    return state._replace(
        kf_q=_write_rows(state.kf_q, slot, pose.q, do),
        kf_t=_write_rows(state.kf_t, slot, pose.t, do),
        kf_kp_xy=_write_rows(state.kf_kp_xy, slot, feats.xy, do),
        kf_kp_depth=_write_rows(state.kf_kp_depth, slot, depth_at_kp, do),
        kf_desc=_write_rows(state.kf_desc, slot, feats.desc, do),
        kf_kp_valid=_write_rows(state.kf_kp_valid, slot, feats.valid, do),
        kf_mp=_write_rows(state.kf_mp, slot, no_mp, do),
        kf_id=_write_rows(state.kf_id, slot, state.num_kf, do),
        num_kf=state.num_kf + do.to(state.num_kf.dtype),
    )


def create_map_points_batched(state: MapState, match, intr_fx, intr_fy,
                              intr_cx, intr_cy,
                              do: torch.Tensor) -> MapState:
    """``create_map_points`` on S stacked maps, each stream between its
    previous and its just-inserted keyframe, where do[s]."""
    m = state.capacity_kf
    prev_slot = torch.remainder(state.num_kf - 2, m)
    curr_slot = torch.remainder(state.num_kf - 1, m)
    matched = match.is_match & do[:, None]
    P = state.capacity_mp

    prev_mp = take_rows(state.kf_mp, prev_slot)               # [S, F]
    prev_live = (prev_mp >= 0) & (prev_mp >= (state.num_mp - P)[:, None])
    needs_new = matched & ~prev_live

    offset = torch.cumsum(needs_new.to(torch.int32), dim=-1) - 1
    new_id = (state.num_mp[:, None] + offset).to(torch.int32)
    n_new = torch.sum(needs_new, dim=-1, dtype=torch.int32)

    xy = take_rows(state.kf_kp_xy, prev_slot)
    z = take_rows(state.kf_kp_depth, prev_slot)
    x = (xy[..., 0] - intr_cx) * z / intr_fx
    y = (xy[..., 1] - intr_cy) * z / intr_fy
    prev_pose = SE3(take_rows(state.kf_q, prev_slot)[:, None],
                    take_rows(state.kf_t, prev_slot)[:, None])
    p_world = prev_pose.apply(torch.stack([x, y, z], dim=-1))  # [S, F, 3]

    mp_slot = torch.remainder(new_id, P)
    mp_pos = scatter_rows_batched(state.mp_pos, mp_slot, needs_new, p_world)
    mp_valid = scatter_rows_batched(state.mp_valid, mp_slot, needs_new,
                                    torch.ones_like(needs_new))

    no_mp = torch.full_like(prev_mp, NO_MP)
    prev_mp_new = torch.where(needs_new, new_id,
                              torch.where(prev_live, prev_mp, no_mp))
    curr_mp_new = scatter_rows_batched(take_rows(state.kf_mp, curr_slot),
                                       match.best_idx, matched, prev_mp_new)

    kf_mp = _write_rows(state.kf_mp, prev_slot, prev_mp_new, do)
    kf_mp = _write_rows(kf_mp, curr_slot, curr_mp_new, do)
    return state._replace(kf_mp=kf_mp, mp_pos=mp_pos, mp_valid=mp_valid,
                          num_mp=state.num_mp + n_new)
