"""The corridor out-and-back of tests/test_loop.py:206-261 through the
port's chunked executor (``ChunkedStream``, chunk 8, local BA off), held
to that test's gates: loop-off closes no loop and drifts more than 5 cm;
loop-on closes at least 3 loops, each against a keyframe at least 10
insertions older with at least 40 inliers, and ends with less than a
fifth of loop-off's endpoint drift. The drift is taken on the frame poses
re-expressed against their anchor keyframes' corrected poses, as the
per-frame shell's ``refined_trajectory`` does. (The per-frame run is
tests/test_torch_loop_e2e.py; the full-width chunked run with async BA and
culling is chip_smoke.py's phase 15.)
"""
import numpy as np
import torch

from kbslam_torch.geom.camera import Intrinsics
from kbslam_torch.pipeline import init_state
from kbslam_torch.slam import pose_T, refine_frame_poses
from kbslam_torch.streaming import ChunkedStream
from tests.test_torch_loop_e2e import corridor_cfg, corridor_sequence

torch.set_num_threads(1)


def test_chunked_corridor_out_and_back_closes_loops():
    seq = corridor_sequence()
    intr = Intrinsics.from_matrix(seq.K)
    drift = {}
    for loop_on in (False, True):
        cfg = corridor_cfg(loop_on)
        cs = ChunkedStream(cfg, intr, init_state(cfg, "cpu"), chunk=8)
        got = []
        for i in range(len(seq.rgb)):
            got += cs.feed(seq.rgb[i], seq.depth[i])
        got += cs.flush()
        assert [r["frame"] for r in got] == list(range(len(seq.rgb)))
        est = [pose_T(r["pose_q"], r["pose_t"]) for r in got]
        anchors = [(r["anchor_id"], pose_T(r["anchor_q"], r["anchor_t"]))
                   for r in got]
        refined = refine_frame_poses(est, anchors, cs.state.map)[:, :3, 3]
        drift[loop_on] = float(np.linalg.norm(refined[-1] - refined[0]))
        if not loop_on:
            assert len(cs.loop_events) == 0
        else:
            assert len(cs.loop_events) >= 3, "corridor revisits never closed"
            for e in cs.loop_events:
                assert e["query_id"] - e["cand_id"] >= 10, e
                assert e["inliers"] >= 40, e
    assert drift[False] > 0.05, drift
    assert drift[True] < 0.2 * drift[False], drift
