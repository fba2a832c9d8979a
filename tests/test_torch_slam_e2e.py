"""tests/test_slam.py::test_slam_end_to_end on the port's SLAM.

The same 40 frames of 240x320, the same configuration (``cfg240``) and
every assertion of tests/test_slam.py:28-41 unchanged, for
``ba_mode="disabled"`` and ``"on_keyframe"``, on the CPU with the port's
own minimal sets (its counter-hash sampler).
"""
import numpy as np
import pytest
import torch

from kbslam.eval.trajectory import ate_rmse
from kbslam.io.synthetic import render_sequence
from kbslam_torch.slam import SLAM
from test_slam import cfg240

torch.set_num_threads(1)


@pytest.mark.parametrize("ba_mode", ["disabled", "on_keyframe"])
def test_slam_end_to_end(ba_mode):
    seq = render_sequence(num_frames=40, height=240, width=320)
    slam = SLAM(cfg240(), seq.K, ba_mode=ba_mode, use_mask=False,
                device="cpu")
    for i in range(40):
        slam.process(seq.rgb[i], seq.depth[i])

    n_success = sum(d["success"] for d in slam.diagnostics)
    assert n_success >= 38
    est = np.stack(slam.frame_poses)
    ate = ate_rmse(est[:, :3, 3], seq.poses[:, :3, 3])
    assert ate < 0.05
    assert slam.num_keyframes >= 2
    if ba_mode == "on_keyframe":
        assert len(slam.ba_stats) >= 1
        for s in slam.ba_stats:
            assert s["final_cost"] <= s["initial_cost"] * 1.001
    assert slam.map_points().shape[0] > 50
    assert slam.keyframe_positions().shape[0] == min(slam.num_keyframes, 16)
