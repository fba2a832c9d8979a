"""The arithmetic of the metrics, the result line, the module check and
the describe stage's byte count (CPU)."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from slambench.harness import describe_bytes, report, trace


def test_percentiles_run_over_every_value():
    rng = np.random.default_rng(3)
    v = list(rng.exponential(20.0, 601))
    assert report.median(v) == pytest.approx(np.percentile(v, 50))
    assert report.percentile(v, 95) == pytest.approx(np.percentile(v, 95))
    # one slow frame in twenty moves the p95 and not the median
    slow = [10.0] * 95 + [40.0] * 5
    assert report.median(slow) == 10.0 and report.percentile(slow, 95) > 10.0


def test_rate_and_self_time():
    assert report.rate(1600, 6.0) == pytest.approx(266.6666667)
    with pytest.raises(ValueError):
        report.rate(1, 0.0)
    assert report.self_ms(16.0, 14.0) == 2.0


def test_result_line_is_compact_and_ends_with_the_check():
    bd = {"device_ops": [["k" * 40, 0.123456789012]] * 10,
          "idle_gaps": [["frame: " + "x" * 28, 0.00123456789]] * 10}
    metrics = {f"metric_{i}": 1234.5678901234 for i in range(4)}
    line = report.result_line(True, 600, 0, metrics,
                              {k: "ms" for k in metrics},
                              {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                               "count": 1, "memory_peak_bytes": 51203283968,
                               "busy_s": 0.5, "window_s": 0.9},
                              {"pose_mm": (0.0, 1.5), "kp_pct": (0.0, 2.0)}, bd)
    assert len(line) < 1800
    out = json.loads(line)
    assert list(out)[-1] == "check" and out["check"]["pose_mm"] == [0.0, 1.5]
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]


def test_forbidden_modules_compare_whole_top_level_names():
    mods = {"kbslam_torch": 1, "kbslam_torch.slam": 1, "jaxtyping": 1,
            "slambench.reference": 1}
    assert report.forbidden_modules(mods) == []
    for bad in ("jax", "jax.numpy", "jaxlib.xla", "flax", "kbslam",
                "kbslam.slam"):
        assert report.forbidden_modules({**mods, bad: 1}) == [bad]


def test_the_harness_itself_loads_no_jax():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, '.');"
            "from slambench.harness import report, manifest, scene, compare, "
            "trace, control, describe_bytes, trajectory;"
            "import slambench.reference.pipeline, slambench.reference.ba.local_ba;"
            "print(report.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(report.__file__).rsplit(
                             "/slambench/", 1)[0], check=True)
    assert out.stdout.strip() == "[]"


def test_union_and_self_time_of_spans():
    assert trace._union([(0, 5), (3, 8), (10, 12)]) == [[0, 8], [10, 12]]
    launch = trace.Launch("cudaGraphLaunch", 0,
                          [("kernel_a", 2_000_000), ("Memcpy HtoD", 500_000)])
    assert launch.device_ms == 2.0 and launch.count() == 1


def _patch_inputs(h, w, n, seed):
    """``chip_smoke.patch_inputs``: a random [8, h, w] pyramid and n
    clamped patch origins, a third at or past a level's far edge."""
    from slambench.reference.frontend.image import pyramid_sizes

    rng = np.random.default_rng(seed)
    sizes = np.asarray(pyramid_sizes(h, w, 8, 1.2), np.int32)
    stacked = np.zeros((8, h, w), np.float32)
    for lv, (hl, wl) in enumerate(sizes):
        stacked[lv, :hl, :wl] = rng.random((hl, wl), np.float32) * 255
    level = rng.integers(0, 8, n).astype(np.int32)
    hw = sizes[level]
    xy = rng.random((n, 2)) * hw[:, ::-1]
    edge = rng.random(n) < 0.33
    xy[edge] = hw[edge, ::-1] - 1 + rng.integers(-3, 25, (edge.sum(), 2))
    base = np.round(xy).astype(np.int32)
    x0 = np.clip(base[:, 0] - 20, 0, np.maximum(hw[:, 1] - 40, 0))
    y0 = np.clip(base[:, 1] - 20, 0, np.maximum(hw[:, 0] - 40, 0))
    return [torch.from_numpy(np.ascontiguousarray(a))
            for a in (stacked, level, y0.astype(np.int32), x0.astype(np.int32))]


def test_describe_bytes_of_eight_streams_match_the_recorded_count():
    """PERF.md's 33.0 MB for 8 x 3072 keypoints of [8, 480, 640] (26.3 MB
    covered, 6.4 MB written), on the same inputs."""
    total = sum(describe_bytes.stage_bytes(*_patch_inputs(480, 640, 3072,
                                                          100 + i))
                for i in range(8))
    assert total == pytest.approx(33.0e6, rel=0.01)


def test_describe_bytes_of_one_frame_match_the_recorded_count():
    """PERF.md's 4.11 MB for 3072 keypoints of one [8, 480, 640] pyramid
    (phase 4's inputs; that count adds the origins read and the pair
    table, about 1%)."""
    got = describe_bytes.stage_bytes(*_patch_inputs(480, 640, 3072, 0))
    assert got == pytest.approx(4.11e6, rel=0.02)


def test_describe_bytes_of_a_rendered_frame_lie_between_their_parts():
    """Through the reference's frontend on a rendered 640x480 frame: at
    least the bytes written, at most those plus the whole pyramid."""
    from kbslam_torch.io import synthetic

    from slambench.reference import config
    from slambench.reference.frontend.image import pyramid_sizes
    from slambench.reference.geom.camera import Intrinsics

    seq = synthetic.render_sequence(num_frames=2, height=480, width=640)
    cfg = config.SLAMConfig()
    got = describe_bytes.frame_bytes(
        cfg, Intrinsics.from_matrix(seq.K), torch.from_numpy(seq.rgb[1]),
        torch.from_numpy(seq.depth[1].astype(np.int32)), None)
    written = cfg.orb.max_features * describe_bytes.WRITTEN_PER_KEYPOINT
    pyramid = 4 * sum(h * w for h, w in pyramid_sizes(480, 640, 8, 1.2))
    assert written < got <= written + pyramid
