"""Checkpoint and resume of the tracking state.

Port of kbslam/io/checkpoint.py, with its npz layout, names and dtypes,
so that either package loads the other's checkpoints: ``map.<field>``
for every MapState field, ``track.{pose_q,pose_t,frames_since_kf,
frame_count}``, an optional ``trajectory`` [N, 4, 4] and ``meta.<key>``
float64 scalars, with dense mapping the volume as ``tsdf.tsdf`` and
``tsdf.weight``, and with dense submaps the atlas as ``atlas.<field>``
for every ``SubmapAtlas`` field (``count`` a 0-d int32) and
``atlas.kf_insertions``, the shell's count of fused keyframe frames, so
that the every-K cadence of new submaps resumes in phase. The file is
written beside its path and published with ``os.replace`` (atomic).
Loading checks every map field's shape against the configuration and
widens the integer fields as ``convert`` does; ``load_checkpoint_tsdf``
checks the volume's dims, ``load_checkpoint_atlas`` the atlas's dims and
ring capacity.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from kbslam_torch import convert
from kbslam_torch.mapping.dense import TSDFState
from kbslam_torch.mapping.state import MapState
from kbslam_torch.mapping.submap import SubmapAtlas
from kbslam_torch.pipeline import TrackState, init_state

_FIELDS_TRACK = ["pose_q", "pose_t", "frames_since_kf", "frame_count"]


def save_checkpoint(path: str, state: TrackState,
                    trajectory: Optional[List[np.ndarray]] = None,
                    tsdf=None, atlas=None, kf_insertions: int = 0,
                    meta: Optional[dict] = None) -> None:
    """``tsdf``: the dense volume (``mapping.dense.TSDFState``), saved so
    that a dense run resumes with it. ``atlas``: the submap atlas
    (``mapping.submap.SubmapAtlas``), with ``kf_insertions`` the shell's
    count of keyframe frames fused into it. ``meta``: a flat dict of
    scalar run metadata, stored as meta.* entries and read back by
    ``load_checkpoint_meta``."""
    host = convert.to_numpy(state)
    arrs = {f"map.{name}": val for name, val in host.map._asdict().items()}
    for name in _FIELDS_TRACK:
        arrs[f"track.{name}"] = np.asarray(getattr(host, name))
    if trajectory is not None and len(trajectory):
        arrs["trajectory"] = np.stack(trajectory)
    if tsdf is not None:
        vol = convert.tsdf_to_numpy(tsdf)
        arrs["tsdf.tsdf"], arrs["tsdf.weight"] = vol.tsdf, vol.weight
    if atlas is not None:
        for name, val in convert.atlas_to_numpy(atlas)._asdict().items():
            arrs[f"atlas.{name}"] = val
        arrs["atlas.kf_insertions"] = np.int32(kf_insertions)
    for k, v in (meta or {}).items():
        arrs[f"meta.{k}"] = np.float64(v)
    tmp = path + ".tmp.npz"  # savez appends .npz unless present
    np.savez_compressed(tmp, **arrs)
    os.replace(tmp, path)  # atomic publish


def load_checkpoint_meta(path: str) -> dict:
    """Scalar run metadata written via save_checkpoint(meta=...); an
    empty dict when the checkpoint carries none."""
    with np.load(path) as z:
        return {k[len("meta."):]: float(z[k]) for k in z.files
                if k.startswith("meta.")}


def load_checkpoint(path: str, cfg, device
                    ) -> Tuple[TrackState, Optional[np.ndarray]]:
    """(state on ``device``, trajectory or None). Shapes must match cfg."""
    expected = init_state(cfg, "meta").map
    with np.load(path) as z:
        fields = {}
        for name in MapState._fields:
            arr = z[f"map.{name}"]
            want = tuple(getattr(expected, name).shape)
            if arr.shape != want:
                raise ValueError(f"checkpoint field map.{name} has shape "
                                 f"{arr.shape}, config expects {want}")
            fields[name] = arr
        track = {n: z[f"track.{n}"] for n in _FIELDS_TRACK}
        traj = z["trajectory"] if "trajectory" in z.files else None
    state = convert.to_torch(TrackState(map=MapState(**fields), **track),
                             device)
    return state, traj


def load_checkpoint_tsdf(path: str, cfg, device) -> Optional[TSDFState]:
    """The saved dense volume on ``device``, or None when the checkpoint
    has none. Its dims must equal ``cfg.dense.dims``."""
    with np.load(path) as z:
        if "tsdf.tsdf" not in z.files:
            return None
        t, w = z["tsdf.tsdf"], z["tsdf.weight"]
    if t.shape != tuple(cfg.dense.dims):
        raise ValueError(f"checkpoint TSDF dims {t.shape} != config "
                         f"{tuple(cfg.dense.dims)}")
    return convert.tsdf_to_torch(TSDFState(t, w), device)


def load_checkpoint_atlas(path: str, cfg, device
                          ) -> Tuple[Optional[SubmapAtlas], int]:
    """(the saved atlas on ``device``, its ``kf_insertions``), or (None,
    0) when the checkpoint has none. Its shape must equal
    (``cfg.dense.max_submaps``, *``cfg.dense.dims``)."""
    with np.load(path) as z:
        if "atlas.tsdf" not in z.files:
            return None, 0
        fields = {n: z[f"atlas.{n}"] for n in SubmapAtlas._fields}
        kf_ins = int(z["atlas.kf_insertions"])
    want = (cfg.dense.max_submaps,) + tuple(cfg.dense.dims)
    if fields["tsdf"].shape != want:
        raise ValueError(f"checkpoint atlas shape {fields['tsdf'].shape}"
                         f" != config {want}")
    return convert.atlas_to_torch(SubmapAtlas(**fields), device), kf_ins
