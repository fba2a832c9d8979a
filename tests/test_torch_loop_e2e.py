"""The corridor out-and-back of tests/test_loop.py:206-261 on the port's
own per-frame shell, held to that test's gates: loop-off closes no loop
and drifts more than 5 cm; loop-on closes at least 3 loops, each against
a keyframe at least 10 insertions older, and ends with less than a fifth
of loop-off's endpoint drift. (The full 79 frames: a shorter corridor
does not revisit enough to close 3 loops. The full-width run is
chip_smoke.py's phase 13; lost-and-found is in tests/test_torch_loop.py.)
"""
import numpy as np
import torch

from kbslam_torch import config as C
from kbslam_torch.io.synthetic import corridor_trajectory, render_sequence
from kbslam_torch.slam import SLAM

torch.set_num_threads(1)


def corridor_cfg(loop_on, height=240, width=320, orb=None):
    """tests/test_loop.py:234-244's configuration (the port's config)."""
    return C.SLAMConfig(
        image_height=height, image_width=width,
        orb=orb or C.OrbConfig(num_features=512, num_levels=4,
                               max_features=512),
        pnp=C.PnPConfig(num_hypotheses=128),
        policy=C.KeyframePolicyConfig(min_frame_gap=3,
                                      rotation_threshold_deg=2.0),
        map=C.MapConfig(max_keyframes=64, max_map_points=32768),
        loop=C.LoopConfig(enabled=loop_on, min_separation=10, score_min=0.7,
                          min_inliers=40, max_trans_disc=0.45,
                          max_rot_disc_deg=15.0))


def corridor_sequence(height=240, width=320):
    out = corridor_trajectory(40)
    poses = np.concatenate([out, out[::-1][1:]])
    return render_sequence(num_frames=len(poses), height=height, width=width,
                           fx=260.0 * width / 320, scene="corridor",
                           depth_noise_mm=1.0, seed=2, poses=poses)


def test_corridor_out_and_back_closes_loops():
    seq = corridor_sequence()
    drift = {}
    for loop_on in (False, True):
        s = SLAM(corridor_cfg(loop_on), seq.K, ba_mode="on_keyframe",
                 use_mask=False, device="cpu")
        for i in range(len(seq.rgb)):
            s.process(seq.rgb[i], seq.depth[i])
        refined = s.refined_trajectory()[:, :3, 3]
        drift[loop_on] = float(np.linalg.norm(refined[-1] - refined[0]))
        if not loop_on:
            assert len(s.loop_events) == 0
        else:
            assert len(s.loop_events) >= 3, "corridor revisits never closed"
            for e in s.loop_events:
                assert e["query_id"] - e["cand_id"] >= 10, e
                assert e["inliers"] >= 40, e
    assert drift[False] > 0.05, drift
    assert drift[True] < 0.2 * drift[False], drift
