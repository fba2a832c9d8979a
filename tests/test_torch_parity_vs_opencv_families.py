"""The port's SLAM against the OpenCV + scipy reference oracle: the
corridor and low-texture families of tests/test_parity_vs_opencv.py at
seeds 0-1 (full system), with the JAX shell's minimal sets. The bound
and the oracle are those of test_torch_parity_vs_opencv.py, which holds
the textured plane's seeds and explains the draws.
"""
import pytest
import torch

from test_parity_vs_opencv import _cfg240, _oracle_ates, _run_oracle
from test_torch_parity_vs_opencv import _port_ates, _run_port, family_sequence

torch.set_num_threads(1)


@pytest.mark.parametrize("family", ["corridor", "lowtex"])
@pytest.mark.parametrize("seed", [0, 1])
def test_port_ate_parity_new_scene_families(family, seed):
    seq = family_sequence(family, seed)
    oracle = _run_oracle(seq, num_features=512)
    ate_oracle, kf_oracle = _oracle_ates(oracle, seq)
    assert len(oracle.ba_reports) >= 2, "oracle BA never ran"

    port = _run_port(_cfg240(), seq, "on_keyframe")
    ate_on, ate_refined, kf_port = _port_ates(port, seq)
    fails = sum(not d["success"] for d in port.diagnostics)
    print(f"{family} s{seed}: port refined {ate_refined * 1e3:.1f} (online "
          f"{ate_on * 1e3:.1f}, kf {kf_port * 1e3:.1f}) vs oracle "
          f"{ate_oracle * 1e3:.1f} (kf {kf_oracle * 1e3:.1f})")
    assert fails <= 3, fails
    assert ate_refined <= ate_oracle * 1.05 + 2e-3, (ate_refined, ate_oracle)
    assert kf_port <= kf_oracle + 1e-3, (kf_port, kf_oracle)
