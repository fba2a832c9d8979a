"""Carry tracking state between the JAX package and the port.

The system has no weights: its state is the map. ``to_torch`` turns a
JAX ``TrackState`` / ``MapState`` — after ``jax.device_get``, i.e. numpy
arrays, or any object with the same field names — into the port's state
on a device; ``to_numpy`` turns the port's state back into the same
NamedTuples holding numpy arrays, which the JAX types accept field by
field (``kbslam.mapping.state.MapState(**m._asdict())``).
"""
from __future__ import annotations

import numpy as np
import torch

from kbslam_torch.mapping.state import MapState
from kbslam_torch.pipeline import TrackState

_INT32 = ("kf_mp", "kf_id", "num_kf", "num_mp")


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
