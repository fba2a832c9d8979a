"""The port's I/O surfaces against the JAX reference: the TUM reader
(the port's own copy of kbslam/io/tum.py) on the generated sequence of
tests/test_io.py, and ``python -m kbslam_torch.cli`` on the CPU with the
TUM source, the chunked executor, checkpoint and resume, and the flag
checks the reference's CLI makes."""
import json

import numpy as np
import pytest
import torch

from kbslam.io.tum import TUMDataset as JTUM
from kbslam_torch import cli
from kbslam_torch.io.tum import TUMDataset as TTUM
from test_io import tum_fixture  # noqa: F401  (a fixture)

torch.set_num_threads(1)
SMALL = ["--frames", "4", "--width", "160", "--height", "120",
         "--device", "cpu"]


def _main(capsys, *args):
    cli.main([*args, *SMALL])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_tum_reader_matches_reference(tum_fixture):  # noqa: F811
    root, seq = tum_fixture
    j, t = JTUM(str(root)), TTUM(str(root))
    assert len(t) == len(j) == 6
    assert t.pairs == j.pairs and t.depth_scale == j.depth_scale
    np.testing.assert_array_equal(t.K, j.K)
    for (rt, dt, mt, gt), (rj, dj, mj, gj) in zip(t, j):
        assert rt.dtype == np.uint8 and dt.dtype == np.uint16
        np.testing.assert_array_equal(rt, rj)
        np.testing.assert_array_equal(dt, dj)
        assert mt is None and mj is None
        np.testing.assert_array_equal(gt, gj)
    np.testing.assert_allclose(next(iter(t))[3], seq.poses[0], atol=1e-6)


def test_cli_tum_source(tum_fixture, capsys):  # noqa: F811
    root, _ = tum_fixture
    s = _main(capsys, "--source", f"tum:{root}", "--ba", "off", "--eval")
    assert s["frames"] == 4     # the reference's check (tests/test_io.py)
    assert {"ate_rmse_m", "rpe_trans_m", "rpe_rot_rad"} <= set(s)


def test_cli_chunked_checkpoint_and_resume(tmp_path, capsys):
    """--chunk 4 --gray writes a checkpoint (with the trajectory) and a
    TUM-format trajectory; the chunked and the per-frame paths resume
    from it."""
    ckpt, traj = str(tmp_path / "state.npz"), str(tmp_path / "traj.txt")
    s1 = _main(capsys, "--ba", "off", "--chunk", "4", "--gray", "--eval",
               "--save-checkpoint", ckpt, "--save-trajectory", traj)
    assert s1["frames"] == 4 and s1["chunk"] == 4 and s1["gray_ingress"]
    assert s1["success"] >= 3 and "ate_rmse_m" in s1
    with np.load(ckpt) as z:
        assert z["trajectory"].shape == (4, 4, 4)
        assert int(z["track.frame_count"]) == 4
    rows = np.loadtxt(traj)
    assert rows.shape == (4, 8)
    np.testing.assert_allclose(np.linalg.norm(rows[:, 4:], axis=1), 1,
                               atol=1e-6)
    s2 = _main(capsys, "--ba", "off", "--chunk", "4", "--resume", ckpt)
    s3 = _main(capsys, "--ba", "off", "--resume", ckpt)
    # the resumed map holds the first run's keyframes: the opening frames
    # re-track against its newest one, so the earliest may lose a success
    # against the fresh run (the slack of tests/test_io.py:204-212)
    for s in (s2, s3):
        assert s["frames"] == 4 and s["success"] >= s1["success"] - 1


@pytest.mark.parametrize("args,message", [
    (["--chunk", "4"], "--chunk batches frames per dispatch"),
    (["--gray"], "--gray requires --chunk"),
    (["--loop", "--dense"], "dense mapping"),
    (["--global-ba"], "unrecognized arguments"),
    (["--dense"], "dense mapping"),
    (["--viewer", "rerun"], "viewer"),
    (["--source", "zmq"], "unknown --source"),
])
def test_cli_refuses_what_the_reference_refuses_or_is_not_ported(
        args, message, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main([*args, *SMALL])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert message in err
    if message in ("dense mapping", "viewer"):
        assert "ROADMAP.md" in err


@pytest.mark.parametrize("extra", [[], ["--chunk", "4", "--ba", "async"]])
def test_cli_loop_reloc_cull(extra, capsys):
    """--loop, --reloc N and --cull, per frame and chunked, as the
    reference's CLI takes them: the summary gains loop_closures and
    relocalizations (kbslam/cli.py:321-324, 516-519)."""
    s = _main(capsys, "--loop", "--reloc", "2", "--cull", "--eval", *extra)
    assert s["frames"] == 4 and s["success"] == 3
    assert s["loop_closures"] == 0 and s["relocalizations"] == 0
    assert "ate_rmse_m" in s
    only_reloc = _main(capsys, "--reloc", "2", *extra)
    assert "relocalizations" in only_reloc and "loop_closures" not in only_reloc
