"""Submap TSDF atlas: a dense model that follows BA and loop corrections.

Port of kbslam/mapping/submap.py. The monolithic volume of
``mapping/dense.py`` is not re-warped by a loop correction; the atlas
splits the model into rigid chunks instead, each anchored to a keyframe,
fuses locally, and re-poses chunks (not voxels) when the trajectory is
corrected:

- the atlas is one ``[S, nx, ny, nz]`` pair of tensors, a ring of S
  submaps. Opening a submap resets one slot; fusing writes one slot.
  Both write the slot in place (the tensors of the atlas a call is given
  are the tensors of the atlas it returns), so neither copies the ring;
- each submap's local frame is its anchor keyframe's camera frame. A
  fusion converts the frame pose to that frame (``anchor^-1 @ frame``)
  and reuses ``dense.integrate`` unchanged: the local box sits in front
  of the anchor camera as the monolithic box sits in front of the start
  pose;
- a correction needs no propagation: extraction re-reads each anchor
  keyframe's current pose from the map ring by its global id (the stored
  anchor pose when the ring slot was since reallocated), so local BA and
  loop corrections reach the dense model as world = anchor_now @ local.

``count`` is a host int, not a device scalar as in the reference: the
shells know how many submaps they opened, and a count on the device
would cost a host sync wherever the host needs it. Opening and fusing
index the ring on the device (``index_select``/``index_copy_``) at the
slot the count picks, or at a slot the caller loaded into a device
tensor, so neither reads the device, a fusion can run between the
replays of the chunk graph, and the per-frame shell captures one graph
for each that opens or fuses any slot. ``live_slots``,
``anchor_poses_now``, ``recent_slots_with_poses``, ``atlas_mesh`` and
``extract_atlas_surface`` are host-side and read the device freely; the
per-frame shell's ICP refine calls ``recent_slots_with_poses`` on every
frame, and names the counter (``syncs``) that each of its six blocking
reads counts in (``utils.profiling``).

``integrate_active`` marks its work as the stage ``fuse``
(``utils.profiling.mark``).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from kbslam_torch.config import DenseMapConfig
from kbslam_torch.device import pick_device
from kbslam_torch.geom.camera import Intrinsics
from kbslam_torch.geom.se3 import SE3
from kbslam_torch.mapping.dense import TSDFState, integrate, surface_points
from kbslam_torch.utils import profiling


class SubmapAtlas(NamedTuple):
    tsdf: torch.Tensor          # [S, nx, ny, nz] f32
    weight: torch.Tensor        # [S, nx, ny, nz] f32
    anchor_q: torch.Tensor      # [S, 4] anchor pose used last (wxyz)
    anchor_t: torch.Tensor      # [S, 3]
    anchor_kf_id: torch.Tensor  # [S] i32 global keyframe id (-1 = empty)
    count: int                  # submaps opened so far (host)

    @property
    def capacity(self) -> int:
        return self.tsdf.shape[0]

    def active_slot(self) -> int:
        """Ring slot of the newest submap (meaningless while count == 0)."""
        return (self.count - 1) % self.capacity


def empty_atlas(cfg: DenseMapConfig, num_submaps: int,
                device=None) -> SubmapAtlas:
    dev = pick_device(device)
    s = num_submaps
    q = torch.zeros((s, 4), dtype=torch.float32, device=dev)
    q[:, 0] = 1.0
    return SubmapAtlas(
        tsdf=torch.ones((s,) + tuple(cfg.dims), dtype=torch.float32,
                        device=dev),
        weight=torch.zeros((s,) + tuple(cfg.dims), dtype=torch.float32,
                           device=dev),
        anchor_q=q,
        anchor_t=torch.zeros((s, 3), dtype=torch.float32, device=dev),
        anchor_kf_id=torch.full((s,), -1, dtype=torch.int32, device=dev),
        count=0)


def slot_index(atlas: SubmapAtlas, slot) -> torch.Tensor:
    """A ring slot (a host int, or a 0-d or [1] integer tensor on the
    atlas's device) as a [1] int64 index on the atlas's device."""
    if torch.is_tensor(slot):
        return slot.reshape(1).to(torch.int64)
    return torch.full((1,), int(slot), dtype=torch.int64,
                      device=atlas.tsdf.device)


def start_submap(atlas: SubmapAtlas, q, t, kf_id: int,
                 slot=None) -> SubmapAtlas:
    """Open a new submap anchored at camera-to-world (q, t), the pose of
    the keyframe with global id ``kf_id`` (a host int, or a 0-d int32
    tensor on the atlas's device); the oldest slot is overwritten when
    the ring is full. ``slot`` (default: the next, from the host count)
    may be a device tensor: the per-frame shell loads it before each
    replay of its graph, which then opens any slot."""
    idx = slot_index(atlas, atlas.count % atlas.capacity
                      if slot is None else slot)
    atlas.tsdf.index_fill_(0, idx, 1.0)
    atlas.weight.index_fill_(0, idx, 0.0)
    atlas.anchor_q.index_copy_(0, idx, q.reshape(1, 4))
    atlas.anchor_t.index_copy_(0, idx, t.reshape(1, 3))
    if torch.is_tensor(kf_id):
        atlas.anchor_kf_id.index_copy_(0, idx, kf_id.reshape(1))
    else:
        atlas.anchor_kf_id.index_fill_(0, idx, int(kf_id))
    return atlas._replace(count=atlas.count + 1)


def integrate_active(atlas: SubmapAtlas, depth_m, q, t, intr: Intrinsics,
                     cfg: DenseMapConfig, anchor_q=None,
                     anchor_t=None, slot=None) -> SubmapAtlas:
    """Fuse one metric depth image taken at world pose (q, t) into the
    active submap, in that submap's anchor-camera frame.

    ``anchor_q``/``anchor_t``: the anchor keyframe's current ring pose.
    Frame poses live in the current (BA- or loop-corrected) gauge, so the
    local conversion must use the anchor's pose in the same gauge: the
    pose the submap was opened at, after a correction, would bake the
    correction into the chunk, and extraction (which re-poses by the
    current anchor pose) would apply it twice. The pose used is stored
    back as the slot's anchor, so extraction's fallback stays consistent
    with the newest content. Defaults to the stored anchor pose.
    ``slot``: the active slot, from the host count by default, or a
    device tensor as in ``start_submap``."""
    profiling.mark(None, depth_m)
    idx = slot_index(atlas, atlas.active_slot() if slot is None else slot)
    if anchor_q is None:
        anchor_q = atlas.anchor_q.index_select(0, idx)[0]
        anchor_t = atlas.anchor_t.index_select(0, idx)[0]
    anchor = SE3(anchor_q, anchor_t)
    local = anchor.inverse() @ SE3(q, t)
    sub = integrate(TSDFState(atlas.tsdf.index_select(0, idx)[0],
                              atlas.weight.index_select(0, idx)[0]),
                    depth_m, local, intr, cfg)
    atlas.tsdf.index_copy_(0, idx, sub.tsdf[None])
    atlas.weight.index_copy_(0, idx, sub.weight[None])
    # a copy: the caller's anchor pose may be a view of that very row
    atlas.anchor_q.index_copy_(0, idx, anchor.q.reshape(1, 4).clone())
    atlas.anchor_t.index_copy_(0, idx, anchor.t.reshape(1, 3).clone())
    profiling.mark("fuse", depth_m)
    return atlas


@functools.lru_cache(maxsize=8)
def make_submap_ops(cfg: DenseMapConfig, intr: Intrinsics, num_submaps: int,
                    depth_scale: float = 1.0):
    """``(start, fuse)``: ``start(atlas, q, t, kf_id, slot=None)`` and
    ``fuse(atlas, depth_raw, q, t, anchor_q, anchor_t, slot=None)``,
    where the caller passes the anchor's current ring pose (see
    ``integrate_active``) and ``depth_scale`` turns the raw image into
    metres."""
    def fuse(atlas, depth_raw, q, t, anchor_q, anchor_t, slot=None):
        return integrate_active(atlas, depth_raw.to(torch.float32)
                                * depth_scale, q, t, intr, cfg, anchor_q,
                                anchor_t, slot)
    return start_submap, fuse


def live_slots(atlas: SubmapAtlas) -> np.ndarray:
    """Ring slots holding a live submap, oldest first."""
    c, s = int(atlas.count), atlas.capacity
    n = min(c, s)
    return np.array([(c - n + k) % s for k in range(n)], np.int32)


def _host(t: torch.Tensor, syncs: Optional[str] = None) -> np.ndarray:
    """``t`` on the host: a blocking read, counted in the counter
    ``syncs`` when one is named."""
    if syncs is not None:
        profiling.count(syncs)
    return t.cpu().numpy()


def _ring(map_state, syncs: Optional[str] = None):
    """The map ring's ids, rotations and translations on the host."""
    return (_host(map_state.kf_id, syncs), _host(map_state.kf_q, syncs),
            _host(map_state.kf_t, syncs))


def anchor_poses_now(atlas: SubmapAtlas, map_state) -> dict:
    """kf_id -> current 4x4 ring pose of every live submap anchor;
    anchors whose ring slot was since reallocated are left out
    (extraction then uses the stored anchor pose). Shared by the
    per-frame shell and the chunked stream."""
    from kbslam_torch.slam import pose_T

    ring_ids, qs, ts = _ring(map_state)
    cap = ring_ids.shape[0]
    ids = atlas.anchor_kf_id.cpu().numpy()
    poses = {}
    for slot in live_slots(atlas):
        kid = int(ids[slot])
        if kid >= 0 and ring_ids[kid % cap] == kid:
            poses[kid] = pose_T(qs[kid % cap], ts[kid % cap])
    return poses


def recent_slots_with_poses(atlas: SubmapAtlas, map_state, k: int,
                            exclude_active: bool = False,
                            syncs: Optional[str] = None):
    """The newest (up to) ``k`` live slots, newest first, each with its
    anchor keyframe's current ring pose (the stored anchor pose when the
    ring slot was since reallocated). A short window is padded by
    repeating its last entry, which ``icp.align_depth_to_atlas``'s
    first-valid-wins selection ignores. Returns (slots [k] i32, anchor_q
    [k, 4] f32, anchor_t [k, 3] f32) as numpy, or None when no slot
    qualifies.

    ``exclude_active`` drops the newest, actively fused submap: the
    independent evidence of ICP "refine", geometry fused under poses not
    correlated with the most recent drift. ``syncs``: the counter each of
    the six blocking reads counts in."""
    slots = live_slots(atlas)[::-1]
    if exclude_active and len(slots):
        slots = slots[1:]
    if not len(slots):
        return None
    slots = slots[:k]
    ring_ids, qs, ts = _ring(map_state, syncs)
    cap = ring_ids.shape[0]
    ids = _host(atlas.anchor_kf_id, syncs)
    aq, at = _host(atlas.anchor_q, syncs), _host(atlas.anchor_t, syncs)
    out_q, out_t = [], []
    for s in slots:
        kid = int(ids[s])
        if kid >= 0 and ring_ids[kid % cap] == kid:
            out_q.append(qs[kid % cap])
            out_t.append(ts[kid % cap])
        else:
            out_q.append(aq[s])
            out_t.append(at[s])
    while len(out_q) < k:
        slots = np.append(slots, slots[-1])
        out_q.append(out_q[-1])
        out_t.append(out_t[-1])
    return (np.ascontiguousarray(slots[:k], np.int32),
            np.stack(out_q).astype(np.float32),
            np.stack(out_t).astype(np.float32))


def atlas_mesh(atlas: SubmapAtlas, cfg: DenseMapConfig,
               anchor_poses: Optional[dict] = None):
    """Union triangle mesh of the atlas (host-side): each submap's
    marching-tetrahedra mesh re-posed by its anchor's current pose
    (``anchor_poses``: kf_id -> 4x4; the stored anchor pose when absent),
    concatenated. Welded within a submap, not across seams."""
    from kbslam_torch.mapping.mesh import TriangleMesh, marching_tetrahedra
    from kbslam_torch.slam import pose_T

    anchor_poses = anchor_poses or {}
    tsdf, weight = atlas.tsdf.cpu().numpy(), atlas.weight.cpu().numpy()
    ids = atlas.anchor_kf_id.cpu().numpy()
    aq, at = atlas.anchor_q.cpu().numpy(), atlas.anchor_t.cpu().numpy()
    verts, faces, off = [], [], 0
    for slot in live_slots(atlas):
        m = marching_tetrahedra(TSDFState(tsdf[slot], weight[slot]), cfg)
        if m.vertices.shape[0] == 0:
            continue
        T = anchor_poses.get(int(ids[slot]))
        if T is None:
            T = pose_T(aq[slot], at[slot])
        verts.append(m.vertices @ np.asarray(T[:3, :3], np.float32).T
                     + np.asarray(T[:3, 3], np.float32))
        faces.append(m.faces + off)
        off += m.vertices.shape[0]
    if not verts:
        return TriangleMesh(np.zeros((0, 3), np.float32),
                            np.zeros((0, 3), np.int32))
    return TriangleMesh(np.concatenate(verts).astype(np.float32),
                        np.concatenate(faces).astype(np.int32))


def extract_atlas_surface(
        atlas: SubmapAtlas, cfg: DenseMapConfig,
        anchor_poses: Optional[dict] = None,
        min_weight: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """The union surface cloud (host-side): (points [M, 3] world, |tsdf|
    residual [M]). ``anchor_poses`` maps a global kf_id to the current
    4x4 camera-to-world pose of that anchor keyframe; a submap whose
    anchor is absent uses its stored anchor pose."""
    anchor_poses = anchor_poses or {}
    tsdf, weight = atlas.tsdf.cpu().numpy(), atlas.weight.cpu().numpy()
    ids = atlas.anchor_kf_id.cpu().numpy()
    pts_all, res_all = [], []
    for slot in live_slots(atlas):
        pts, res = surface_points(TSDFState(tsdf[slot], weight[slot]), cfg,
                                  min_weight=min_weight)
        if pts.shape[0] == 0:
            continue
        T = anchor_poses.get(int(ids[slot]))
        if T is None:
            T = SE3(atlas.anchor_q[slot].cpu(),
                    atlas.anchor_t[slot].cpu()).matrix().numpy()
        pts_all.append(pts @ np.asarray(T[:3, :3], np.float32).T
                       + np.asarray(T[:3, 3], np.float32))
        res_all.append(res)
    if not pts_all:
        return np.zeros((0, 3), np.float32), np.zeros((0,), np.float32)
    return (np.concatenate(pts_all).astype(np.float32),
            np.concatenate(res_all).astype(np.float32))
