"""Dense ICP through the port's ``SLAM`` shell and CLI, against the JAX
package.

- Rescue through the mask blackout of tests/test_dense_icp.py:118-163
  (frames 16-21 with every pixel masked, ORB starves, the depth stays
  informative), with BA on keyframe, against the volume and against the
  submap atlas (``submap_every=1``), JAX's shell beside the port's with
  JAX's minimal sets injected: the same tracking decisions and
  ``icp_events`` (frame, mode, accepted), rescued poses within 1 mm of
  JAX's, and that test's gates on the port (>= 4 accepted rescues and
  successes in the blackout, each rescued pose < 8 cm from the ground
  truth, 12 cm with the atlas as in tests/test_dense_icp.py:376-391,
  tracking back after it). Both runs also count relocalization's fail
  streak (``reloc_after=99``, which never fires here): it must go on
  counting through rescued frames (tests/test_dense_icp.py:213-248).
  The 34 frames are not cut: ``render_sequence`` spreads one path over
  however many frames it is asked for, so fewer frames are a faster
  camera, and at 26 the rescued poses miss the gates (8.3 cm, 17.2 cm
  with the atlas, in JAX as in the port);
- refine against the atlas needs independent evidence
  (tests/test_dense_icp.py:432-460, 26 frames): no refine before a
  second submap, accepted refines strictly improve, keyframe frames
  skipped, and the events equal to JAX's;
- the CLI with ``--dense --dense-icp rescue``, with and without
  ``--dense-submaps``.
"""
import dataclasses
import functools
import json
import sys
from io import StringIO

import numpy as np
import pytest
import torch

from kbslam.config import LoopConfig
from kbslam.io.synthetic import render_sequence
from kbslam.slam import SLAM as JSLAM
from kbslam_torch.geom.camera import Intrinsics as TIntr
from kbslam_torch.pipeline import make_track_step as t_make
from kbslam_torch.slam import SLAM as TSLAM
from test_dense_icp import _blackout_cfg
from test_torch_slam import _jax_keyed_sampler

torch.set_num_threads(1)

BLACK = list(range(16, 22))
POSE_M = 1e-3


@functools.lru_cache(maxsize=2)
def _seq(T):
    seq = render_sequence(num_frames=T, height=240, width=320,
                          scene="spheres")
    mask = seq.mask.copy()
    mask[BLACK] = 0
    return seq, mask


def _cfg(mode, submap_every=0):
    cfg = _blackout_cfg()
    return cfg.replace(
        dense=dataclasses.replace(cfg.dense, submap_every=submap_every),
        dense_icp=dataclasses.replace(cfg.dense_icp, mode=mode),
        loop=LoopConfig(reloc_after=99))


def _pair(cfg, use_mask, T):
    """(JAX SLAM, port SLAM, port fail streak per frame) over T frames,
    BA on keyframe, the port with JAX's minimal sets."""
    seq, mask = _seq(T)
    j = JSLAM(cfg, seq.K, ba_mode="on_keyframe", use_mask=use_mask)
    t = TSLAM(cfg, seq.K, ba_mode="on_keyframe", use_mask=use_mask,
              device="cpu")
    t._step = t_make(cfg, TIntr.from_matrix(seq.K), use_mask=use_mask,
                     sampler_for_frame=_jax_keyed_sampler)
    streaks = []
    for i in range(T):
        m = mask[i] if use_mask else None
        j.process(seq.rgb[i], seq.depth[i], m)
        t.process(seq.rgb[i], seq.depth[i], m)
        streaks.append(t._fail_streak)
    return j, t, streaks


def _events(s):
    return [(e["frame"], e["mode"], e["accepted"]) for e in s.icp_events]


@pytest.mark.parametrize("submap_every,gate_m", [(0, 0.08), (1, 0.12)])
def test_rescue_through_mask_blackout_matches_reference(submap_every,
                                                        gate_m):
    seq, _ = _seq(34)
    j, t, streaks = _pair(_cfg("rescue", submap_every), use_mask=True, T=34)
    keys = ("success", "added_kf")
    assert ([[d[k] for k in keys] for d in t.diagnostics]
            == [[d[k] for k in keys] for d in j.diagnostics])
    assert _events(t) == _events(j)
    rescued = [e for e in t.icp_events
               if e["mode"] == "rescue" and e["accepted"]]
    assert len(rescued) >= 4, t.icp_events
    assert sum(t.diagnostics[i]["success"] for i in BLACK) >= 4
    T0 = seq.poses[0]
    for e in rescued:
        i = e["frame"]
        gap = np.abs(t.frame_poses[i] - j.frame_poses[i])
        assert gap[:3, 3].max() <= POSE_M and gap[:3, :3].max() <= POSE_M
        err = np.linalg.norm((T0 @ t.frame_poses[i])[:3, 3]
                             - seq.poses[i][:3, 3])
        assert err < gate_m, (i, err)
    assert t.diagnostics[-1]["success"]
    # the sparse pipeline is still lost while rescues succeed
    assert max(streaks[BLACK[0]:BLACK[-1] + 1]) >= 4, streaks
    assert streaks[-1] == 0


def test_refine_with_submaps_needs_independent_evidence():
    j, t, _ = _pair(_cfg("refine", submap_every=1), use_mask=False, T=26)
    assert _events(t) == _events(j)
    refines = [e for e in t.icp_events if e["mode"] == "refine"]
    assert refines, "refine never ran"
    kf_frames = [d["frame"] for d in t.diagnostics if d["added_kf"]]
    assert len(kf_frames) >= 2
    assert all(e["frame"] > kf_frames[1] for e in refines)
    assert not set(kf_frames) & {e["frame"] for e in refines}
    for e in refines:
        if e["accepted"]:
            assert e["rmse"] < e["rmse_init"], e


@pytest.mark.parametrize("extra", [[], ["--dense-submaps", "2"]])
def test_cli_dense_icp(extra):
    from kbslam_torch.cli import main

    cap, old = StringIO(), sys.stdout
    sys.stdout = cap
    try:
        main(["--device", "cpu", "--frames", "4", "--width", "160",
              "--height", "120", "--ba", "off", "--dense", "--dense-icp",
              "rescue", *extra])
    finally:
        sys.stdout = old
    summary = json.loads(cap.getvalue().strip().splitlines()[-1])
    assert {"icp_rescues", "icp_refines"} <= set(summary)
    assert summary["icp_refines"] == 0
    assert ("tsdf_submaps" in summary) == bool(extra)
