"""The port's own copies of the reference's numpy-only modules equal the
originals: ``kbslam_torch/config.py``, ``io/synthetic.py``,
``eval/trajectory.py`` and ``frontend/brief_pattern_learned.npy``.

This is the one place both are imported. The copies differ from the
originals only in their module docstring, which names the file copied.
"""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

import kbslam.config as jconfig
import kbslam.eval.trajectory as jtrajectory
import kbslam.io.synthetic as jsynthetic
from kbslam_torch import config as tconfig
from kbslam_torch.eval import trajectory as ttrajectory
from kbslam_torch.io import synthetic as tsynthetic

REPO = Path(__file__).resolve().parent.parent
COPIES = [("kbslam/config.py", "kbslam_torch/config.py"),
          ("kbslam/io/synthetic.py", "kbslam_torch/io/synthetic.py"),
          ("kbslam/eval/trajectory.py", "kbslam_torch/eval/trajectory.py")]


def _body(path: Path) -> str:
    """The source after the module docstring."""
    src = path.read_text()
    doc = ast.parse(src).body[0]
    assert isinstance(doc, ast.Expr) and isinstance(doc.value, ast.Constant)
    return "\n".join(src.splitlines()[doc.end_lineno:])


@pytest.mark.parametrize("orig,copy", COPIES)
def test_copy_source_equals_original_below_docstring(orig, copy):
    assert _body(REPO / copy) == _body(REPO / orig)
    assert orig in ast.get_docstring(ast.parse((REPO / copy).read_text()))


def test_pattern_file_bytes_equal():
    a = (REPO / "kbslam/frontend/brief_pattern_learned.npy").read_bytes()
    b = (REPO / "kbslam_torch/frontend/brief_pattern_learned.npy").read_bytes()
    assert a == b


def test_config_defaults_equal():
    names = [n for n in dir(jconfig) if isinstance(getattr(jconfig, n), type)
             and dataclasses.is_dataclass(getattr(jconfig, n))]
    assert "SLAMConfig" in names and "OrbConfig" in names
    for n in names:
        assert dataclasses.asdict(getattr(tconfig, n)()) == \
            dataclasses.asdict(getattr(jconfig, n)()), n
    assert dataclasses.asdict(tconfig.DEFAULT_CONFIG) == \
        dataclasses.asdict(jconfig.DEFAULT_CONFIG)
    assert dataclasses.asdict(tconfig.tiny_config()) == \
        dataclasses.asdict(jconfig.tiny_config())


@pytest.mark.parametrize("kwargs", [dict(num_frames=3, height=48, width=64),
                                    dict(num_frames=2, height=60, width=80,
                                         seed=5, scene="spheres",
                                         moving_box=True, depth_noise_mm=2.0,
                                         depth_dropout=0.1, hole_blobs=2)])
def test_rendered_sequences_equal(kwargs):
    a = jsynthetic.render_sequence(**kwargs)
    b = tsynthetic.render_sequence(**kwargs)
    for field in jsynthetic.SyntheticSequence._fields:
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype, field
        np.testing.assert_array_equal(y, x, err_msg=field)


def test_trajectory_metrics_equal():
    seq = tsynthetic.render_sequence(num_frames=2, height=24, width=32)
    gt = tsynthetic.default_trajectory(40)
    rng = np.random.default_rng(2)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(0, 0.01, (40, 3))
    assert seq.poses.shape == (2, 4, 4)
    assert ttrajectory.ate_rmse(est[:, :3, 3], gt[:, :3, 3]) == \
        jtrajectory.ate_rmse(est[:, :3, 3], gt[:, :3, 3])
    assert ttrajectory.rpe(est, gt) == jtrajectory.rpe(est, gt)
    assert ttrajectory.rpe(est, gt, delta=5) == jtrajectory.rpe(est, gt, delta=5)
