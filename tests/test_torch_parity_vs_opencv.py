"""The port's SLAM against the OpenCV + scipy reference oracle.

The cases of tests/test_parity_vs_opencv.py, run through
``kbslam_torch.slam.SLAM`` on the CPU: here seeds 0-2 of the textured
plane at 240x320 (VO and the full system) and the full system at
640x480 with the default configuration; the corridor and low-texture families
at seeds 0-1 (full system) are in test_torch_parity_vs_opencv_families.py.
The oracle is ``kbslam.eval.reference_slam.ReferenceSLAM`` (the
reference's frontend through public cv2 calls and its sliding-window BA
in scipy float64), at the matched 512-feature budget. The bound is that
test's: ATE <= 1.05 x the oracle's + 2 mm, with no floor; keyframe ATE
<= the oracle's + 1 mm; at most 3 failed frames in the families.

At 240x320 the port draws the minimal sets the JAX shell draws
(``test_torch_slam._jax_keyed_sampler``), so the gate compares the two
systems on equal draws; the 640x480 case holds on the port's own. With its own counter-hash draws a single frame
can take another RANSAC basin: on the corridor at seed 1, RANSAC seed 0
puts frame 28 0.42 m off (refined ATE 64.4 mm against the oracle's
29.4 mm), while RANSAC seeds 1-4 give 28.0-28.1 mm and the JAX shell's
seeds 0-4 28.2-30.1 mm. Run as a script (``python
tests/test_torch_parity_vs_opencv.py`` with the repository and
``tests/`` on ``PYTHONPATH``), this file prints the port's refined ATE
on every case for its own draws at RANSAC seeds 0-4.
"""
import numpy as np
import pytest
import torch

from kbslam.eval.trajectory import ate_rmse
from kbslam.io.synthetic import corridor_trajectory, render_sequence
from kbslam_torch.config import DEFAULT_CONFIG
from kbslam_torch.geom.camera import Intrinsics
from kbslam_torch.pipeline import make_track_step
from kbslam_torch.slam import SLAM
from test_parity_vs_opencv import _cfg240, _oracle_ates, _run_oracle
from test_torch_slam import _jax_keyed_sampler

torch.set_num_threads(1)


def _run_port(cfg, seq, ba_mode, seed=None):
    """The port's SLAM over ``seq``: with the JAX shell's minimal sets, or
    with its own draws at RANSAC ``seed``."""
    s = SLAM(cfg, seq.K, ba_mode=ba_mode, use_mask=False, seed=seed or 0,
             device="cpu")
    if seed is None:
        s._step = make_track_step(cfg, Intrinsics.from_matrix(seq.K),
                                  use_mask=False,
                                  sampler_for_frame=_jax_keyed_sampler)
    for i in range(len(seq.rgb)):
        s.process(seq.rgb[i], seq.depth[i])
    return s


def _port_ates(s, seq):
    """(online ATE, refined ATE, keyframe ATE)."""
    gt = seq.poses[:, :3, 3]
    traj = ate_rmse(np.stack(s.frame_poses)[:, :3, 3], gt)
    refined = ate_rmse(s.refined_trajectory()[:, :3, 3], gt)
    kf_frames = [d["frame"] for d in s.diagnostics if d["added_kf"]]
    kf = ate_rmse(s.keyframe_positions(), seq.poses[kf_frames][:, :3, 3])
    return traj, refined, kf


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_port_ate_parity_with_opencv_oracle(seed):
    seq = render_sequence(num_frames=40, height=240, width=320, seed=seed)
    oracle = _run_oracle(seq, num_features=512)
    ate_oracle, kf_oracle = _oracle_ates(oracle, seq)
    assert len(oracle.ba_reports) >= 2, "oracle BA never ran"

    vo = _run_port(_cfg240(), seq, "disabled")
    ate_vo = ate_rmse(np.stack(vo.frame_poses)[:, :3, 3], seq.poses[:, :3, 3])
    full = _run_port(_cfg240(), seq, "on_keyframe")
    _, ate_refined, kf_port = _port_ates(full, seq)
    print(f"seed {seed}: VO {ate_vo * 1e3:.1f} vs {ate_oracle * 1e3:.1f} mm; "
          f"full {ate_refined * 1e3:.1f}; KF {kf_port * 1e3:.1f} vs "
          f"{kf_oracle * 1e3:.1f}")
    assert ate_vo <= ate_oracle * 1.05 + 2e-3, (ate_vo, ate_oracle)
    assert ate_refined <= ate_oracle * 1.05 + 2e-3, (ate_refined, ate_oracle)
    assert kf_port <= kf_oracle + 1e-3, (kf_port, kf_oracle)


def test_port_ate_parity_640x480_full_system():
    """tests/test_parity_vs_opencv.py:106-120 on the port: 30 frames of
    640x480 at ``DEFAULT_CONFIG`` (3000 features on both sides), BA after
    each keyframe, that test's three assertions. The port runs its own
    draws here, as a user runs it (RANSAC seed 0); on one CPU thread:
    refined ATE 4.70 mm (online 5.66 mm), keyframe ATE 0.38 mm, against
    the oracle's 9.54 mm and 7.90 mm."""
    seq = render_sequence(num_frames=30, height=480, width=640, fx=525.0,
                          seed=0)
    ate_oracle, kf_oracle = _oracle_ates(_run_oracle(seq), seq)
    port = _run_port(DEFAULT_CONFIG, seq, "on_keyframe", seed=0)
    ate_on, ate_refined, kf_port = _port_ates(port, seq)
    print(f"640x480: port refined {ate_refined * 1e3:.2f} mm (online "
          f"{ate_on * 1e3:.2f}, keyframes {kf_port * 1e3:.2f}) vs oracle "
          f"{ate_oracle * 1e3:.2f} (keyframes {kf_oracle * 1e3:.2f})")
    assert ate_refined <= ate_oracle * 1.05 + 2e-3, (ate_refined, ate_oracle)
    assert ate_refined < 8e-3, ate_refined
    assert kf_port <= kf_oracle + 1e-3, (kf_port, kf_oracle)


def family_sequence(family, seed):
    """The 60-frame sequences of tests/test_parity_vs_opencv.py:128-140."""
    T = 60
    if family == "corridor":
        return render_sequence(
            num_frames=T, height=240, width=320, seed=seed, scene="corridor",
            poses=corridor_trajectory(T, advance=3.0, yaw_amplitude=0.35))
    return render_sequence(
        num_frames=T, height=240, width=320, seed=seed, texture_rects=250,
        specular=0.5, hole_blobs=3, depth_noise_mm=1.0)


if __name__ == "__main__":
    cases = [("plane", s) for s in (0, 1, 2)] + [
        (f, s) for f in ("corridor", "lowtex") for s in (0, 1)]
    for family, seed in cases:
        seq = (render_sequence(num_frames=40, height=240, width=320,
                               seed=seed) if family == "plane"
               else family_sequence(family, seed))
        ate_oracle, _ = _oracle_ates(_run_oracle(seq, num_features=512), seq)
        got = [_port_ates(_run_port(_cfg240(), seq, "on_keyframe", r), seq)[1]
               for r in range(5)]
        print(f"{family} seed {seed}: oracle {ate_oracle * 1e3:.1f} mm, bound "
              f"{(1.05 * ate_oracle + 2e-3) * 1e3:.1f} mm; port refined ATE "
              f"with its own draws at RANSAC seeds 0-4 "
              f"{[round(a * 1e3, 1) for a in got]} mm", flush=True)
