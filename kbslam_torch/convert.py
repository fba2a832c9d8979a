"""Carry tracking state between the JAX package and the port.

The system has no weights: its state is the map. ``to_torch`` turns a
JAX ``TrackState`` / ``MapState`` — after ``jax.device_get``, i.e. numpy
arrays, or any object with the same field names — into the port's state
on a device; ``to_numpy`` turns the port's state back into the same
NamedTuples holding numpy arrays, which the JAX types accept field by
field (``kbslam.mapping.state.MapState(**m._asdict())``).
``tuple_to_torch`` carries any other NamedTuple of arrays, such as the
loop closure's ``PoseGraph``, ``LoopCandidate`` and ``LoopConstraint``;
``tsdf_to_torch`` and ``tsdf_to_numpy`` carry the dense volume,
``atlas_to_torch`` and ``atlas_to_numpy`` the submap atlas, and
``global_ba_data_to_torch`` and ``global_ba_data_to_numpy`` a global BA
problem.
"""
from __future__ import annotations

import numpy as np
import torch

from kbslam_torch.ba.global_ba import GlobalBAData
from kbslam_torch.mapping.dense import TSDFState
from kbslam_torch.mapping.submap import SubmapAtlas
from kbslam_torch.mapping.state import MapState
from kbslam_torch.pipeline import TrackState

_INT32 = ("kf_mp", "kf_id", "num_kf", "num_mp")


def tuple_to_torch(value, cls, device):
    """Any NamedTuple of arrays (a JAX ``PoseGraph``, ``LoopCandidate`` or
    ``LoopConstraint`` after ``jax.device_get``) as the port's ``cls``
    with the same field names, each field a tensor on ``device`` (a
    copy, with the array's dtype)."""
    return cls(**{name: torch.from_numpy(np.array(getattr(value, name)))
                  .to(device) for name in cls._fields})


def map_to_torch(m, device) -> MapState:
    fields = {}
    for name in MapState._fields:
        a = np.asarray(getattr(m, name))
        if name in _INT32:
            a = a.astype(np.int32)
        # a copy: the port updates map tensors in place
        fields[name] = torch.from_numpy(np.array(a)).to(device)
    return MapState(**fields)


def map_to_numpy(m: MapState) -> MapState:
    return MapState(**{name: getattr(m, name).detach().cpu().numpy().copy()
                       for name in MapState._fields})


def to_torch(state, device) -> TrackState:
    return TrackState(
        map=map_to_torch(state.map, device),
        pose_q=torch.tensor(np.asarray(state.pose_q, np.float32), device=device),
        pose_t=torch.tensor(np.asarray(state.pose_t, np.float32), device=device),
        frames_since_kf=torch.tensor(
            np.asarray(state.frames_since_kf, np.int32), device=device),
        frame_count=torch.tensor(np.asarray(state.frame_count, np.int32),
                                 device=device),
    )


def to_numpy(state: TrackState) -> TrackState:
    return TrackState(
        map=map_to_numpy(state.map),
        pose_q=state.pose_q.detach().cpu().numpy().copy(),
        pose_t=state.pose_t.detach().cpu().numpy().copy(),
        frames_since_kf=state.frames_since_kf.detach().cpu().numpy().copy(),
        frame_count=state.frame_count.detach().cpu().numpy().copy(),
    )


def tsdf_to_torch(state_np, device) -> TSDFState:
    """A volume of arrays (a JAX ``TSDFState`` after ``jax.device_get``,
    or a checkpoint's) as the port's, float32 copies on ``device``."""
    return TSDFState(*(torch.from_numpy(np.array(a, np.float32)).to(device)
                       for a in (state_np.tsdf, state_np.weight)))


def tsdf_to_numpy(state: TSDFState) -> TSDFState:
    """The port's volume as numpy arrays (copies), which the JAX
    ``TSDFState`` and ``mapping/mesh.py`` accept."""
    return TSDFState(*(a.detach().cpu().numpy().copy() for a in state))


def atlas_to_torch(atlas_np, device) -> SubmapAtlas:
    """An atlas of arrays (a JAX ``SubmapAtlas`` after ``jax.device_get``,
    or a checkpoint's) as the port's: copies on ``device`` with the
    reference's dtypes, and ``count`` a host int."""
    def arr(name, dtype):
        return torch.from_numpy(np.array(getattr(atlas_np, name), dtype)
                                ).to(device)
    return SubmapAtlas(
        tsdf=arr("tsdf", np.float32), weight=arr("weight", np.float32),
        anchor_q=arr("anchor_q", np.float32),
        anchor_t=arr("anchor_t", np.float32),
        anchor_kf_id=arr("anchor_kf_id", np.int32),
        count=int(np.asarray(atlas_np.count)))


def atlas_to_numpy(atlas: SubmapAtlas) -> SubmapAtlas:
    """The port's atlas as numpy arrays (copies; ``count`` a 0-d int32),
    which the JAX ``SubmapAtlas`` accepts field by field."""
    return SubmapAtlas(*(a.detach().cpu().numpy().copy() for a in atlas[:5]),
                       count=np.int32(atlas.count))


_GBA_DTYPES = dict(mp_id=np.int32, active=bool, cam_free=bool,
                   anchor_mp=np.int32)


def global_ba_data_to_torch(data_np, device) -> GlobalBAData:
    """A global BA problem of arrays (a JAX ``GlobalBAData`` after
    ``jax.device_get``) as the port's: copies on ``device``, floats as
    float32, ids as int32, masks as bool."""
    return GlobalBAData(**{
        name: torch.from_numpy(np.array(getattr(data_np, name),
                                        _GBA_DTYPES.get(name, np.float32))
                               ).to(device)
        for name in GlobalBAData._fields})


def global_ba_data_to_numpy(data: GlobalBAData) -> GlobalBAData:
    """The port's problem as numpy arrays (copies), which the JAX
    ``GlobalBAData`` accepts field by field."""
    return GlobalBAData(*(a.detach().cpu().numpy().copy() for a in data))
