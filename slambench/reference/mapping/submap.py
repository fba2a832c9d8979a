"""The submap atlas's slot logic and a keyframe's fusion into its slot, as
plain eager torch and host code, frozen from the port
(``kbslam_torch/mapping/submap.py`` and ``slam.py``'s ``_fuse`` and
``anchor_pose_now``) for the benchmark's reference.

The atlas is a ring of S submaps; ``count`` submaps were opened so far,
the newest (the active one) in ring slot ``(count - 1) % S``. A submap's
frame is its anchor keyframe's camera frame. A keyframe's fusion opens
a new submap, anchored at the keyframe, on every ``submap_every``-th
fused keyframe, and then fuses the depth image into the active submap
at ``anchor_now^-1 @ pose``, where ``anchor_now`` is the anchor
keyframe's current pose in the map ring (the stored anchor pose once its
ring slot was reallocated); the pose used is stored as the slot's
anchor.

Departure from the program: the reference holds no ring of S volumes.
An ``Atlas`` keeps the ring's bookkeeping (count, anchors) and a dict of
the volumes of the slots it was given (the check's copies of the slots
a stretch reads or writes), so it never holds the 17 GB ring.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from slambench.reference.geom.se3 import SE3
from slambench.reference.mapping import dense


class Atlas(NamedTuple):
    count: int                  # submaps opened so far
    capacity: int               # ring slots S
    anchor_q: torch.Tensor      # [S, 4] anchor pose used last (wxyz)
    anchor_t: torch.Tensor      # [S, 3]
    anchor_kf_id: torch.Tensor  # [S] i32 global keyframe id (-1 = empty)
    volumes: dict               # ring slot -> dense.TSDFState

    def active_slot(self) -> int:
        return (self.count - 1) % self.capacity


def live_slots(count: int, capacity: int) -> list:
    """Ring slots holding a live submap, oldest first."""
    n = min(count, capacity)
    return [(count - n + k) % capacity for k in range(n)]


def ring_pose(map_state, kid: int, stored_q, stored_t):
    """The keyframe ``kid``'s pose in the map ring, or the stored pose
    when its ring slot holds another keyframe (or ``kid`` < 0)."""
    cap = map_state.kf_id.shape[0]
    if kid >= 0 and int(map_state.kf_id[kid % cap]) == kid:
        return map_state.kf_q[kid % cap], map_state.kf_t[kid % cap]
    return stored_q, stored_t


def recent_slots_with_poses(atlas: Atlas, map_state, k: int,
                            exclude_active: bool):
    """The newest (up to) ``k`` live slots, newest first, each with its
    anchor's current ring pose; a short window repeats its last entry.
    (slots [k] list, anchor_q [k, 4], anchor_t [k, 3]), or None when no
    slot qualifies. ``exclude_active`` leaves the active submap out."""
    slots = live_slots(atlas.count, atlas.capacity)[::-1]
    if exclude_active and slots:
        slots = slots[1:]
    if not slots:
        return None
    slots = slots[:k]
    qs, ts = [], []
    for s in slots:
        q, t = ring_pose(map_state, int(atlas.anchor_kf_id[s]),
                         atlas.anchor_q[s], atlas.anchor_t[s])
        qs.append(q)
        ts.append(t)
    while len(slots) < k:
        slots.append(slots[-1])
        qs.append(qs[-1])
        ts.append(ts[-1])
    return slots, torch.stack(qs), torch.stack(ts)


def fuse_keyframe(atlas: Atlas, kf_insertions: int, submap_every: int,
                  kid: int, depth_m, q, t, map_state, intr, cfg,
                  slab: Optional[int] = None):
    """A keyframe's fusion: open a submap anchored at (q, t), the pose of
    keyframe ``kid``, when ``kf_insertions`` (keyframes fused so far) is
    a multiple of ``submap_every``, then fuse ``depth_m`` [H, W] metres
    into the active slot. ``map_state``: the map after the frame's
    insertion and local BA. Returns (the atlas after, the active slot,
    the local pose fused at). ``slab``: fuse that many x rows at a time
    (all at once by default)."""
    count = atlas.count
    aq, at, ids = (atlas.anchor_q.clone(), atlas.anchor_t.clone(),
                   atlas.anchor_kf_id.clone())
    volumes = dict(atlas.volumes)
    if kf_insertions % submap_every == 0:
        count += 1
        s = (count - 1) % atlas.capacity
        volumes[s] = dense.empty_tsdf(cfg.dims, q.device)
        aq[s], at[s], ids[s] = q, t, kid
    s = (count - 1) % atlas.capacity
    anchor = SE3(*ring_pose(map_state, int(ids[s]), aq[s], at[s]))
    local = anchor.inverse() @ SE3(q, t)
    vol = volumes[s]
    nx = vol.tsdf.shape[0]
    step = nx if slab is None else slab
    parts = [dense.integrate(dense.TSDFState(vol.tsdf[x:x + step],
                                             vol.weight[x:x + step]),
                             depth_m, local, intr, cfg, x)
             for x in range(0, nx, step)]
    volumes[s] = dense.TSDFState(torch.cat([p.tsdf for p in parts]),
                                 torch.cat([p.weight for p in parts]))
    aq[s], at[s] = anchor.q, anchor.t
    return Atlas(count, atlas.capacity, aq, at, ids, volumes), s, local
