"""The port stands on its own and runs on the card unless told otherwise.

- A copy of ``kbslam_torch/`` alone in a temporary directory, with no
  ``kbslam/`` beside it, imports and tracks through its CLI on the CPU,
  and runs the sharded global BA's dryrun over two spawned gloo ranks.
- ``pick_device()`` without a name raises when there is no CUDA device,
  and so does ``SLAM(..., device=None)``; only an explicit ``"cpu"``
  gives the CPU.
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from kbslam_torch import config
from kbslam_torch.device import pick_device
from kbslam_torch.io import synthetic
from kbslam_torch.slam import SLAM

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("extra", [
    [], ["--chunk", "4", "--ba", "off"],
    ["--loop", "--reloc", "2", "--cull", "--chunk", "4", "--ba", "async"],
    ["--dense", "--chunk", "4", "--ba", "off"],
    ["--dense", "--dense-submaps", "2", "--dense-icp", "rescue"],
    ["--global-ba", "--chunk", "4", "--ba", "off"],
    ["--viewer", "rerun", "--dense", "--chunk", "4", "--ba", "off"]])
def test_package_alone_runs_its_cli(tmp_path, extra):
    """Per frame, and through the chunked executor (``--chunk 4``), which
    also imports streaming, io.checkpoint and io.tum's neighbours; with
    loop closure, relocalization and culling on; with dense mapping;
    with the submap atlas and dense ICP; with the end-of-run global BA;
    and with the viewer (a recorder without the rerun SDK) on the
    chunked dense path."""
    shutil.copytree(REPO / "kbslam_torch", tmp_path / "kbslam_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    r = subprocess.run(
        [sys.executable, "-m", "kbslam_torch.cli", "--device", "cpu",
         "--frames", "4", "--width", "160", "--height", "120", "--eval",
         "--save-checkpoint", str(tmp_path / "state.npz"), *extra],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    mods = subprocess.run(
        [sys.executable, "-c", "import sys, kbslam_torch.streaming, "
         "kbslam_torch.io.checkpoint, kbslam_torch.io.tum, kbslam_torch.cli, "
         "kbslam_torch.parallel.multistream, kbslam_torch.parallel.dist, "
         "kbslam_torch.io.zmq_camera, "
         "kbslam_torch.viz.rerun_viewer, kbslam_torch.utils.profiling, "
         "kbslam_torch.utils.logging;"
         " print(sorted(m for m in sys.modules if m.startswith(('jax', "
         "'kbslam.')) or m == 'kbslam'))"],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=120)
    assert mods.returncode == 0 and mods.stdout.strip() == "[]", mods
    assert not (tmp_path / "kbslam").exists()
    where = subprocess.run(
        [sys.executable, "-c", "import kbslam_torch; print(kbslam_torch.__file__)"],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=120)
    assert where.stdout.strip().startswith(str(tmp_path)), where
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    # the first frame initialises the map; every later one tracks
    assert summary["frames"] == 4 and summary["success"] == 3
    assert set(summary) >= {"ate_rmse_m", "rpe_trans_m", "rpe_rot_rad"}
    assert "device cpu" in r.stderr


def test_package_alone_runs_a_process_group(tmp_path):
    """Two spawned ranks of the copied package (gloo) run the sharded
    global BA's dryrun; neither they nor the parent load JAX or kbslam
    (there is none to load)."""
    shutil.copytree(REPO / "kbslam_torch", tmp_path / "kbslam_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    code = ("import sys; from kbslam_torch.parallel import dist; "
            "from kbslam_torch.ba.global_ba import dryrun_sharded_global_ba; "
            "print(dist.spawn(dryrun_sharded_global_ba, 2, 'cpu', "
            "timeout_s=120)); "
            "print(sorted(m for m in sys.modules if m.startswith(('jax', "
            "'kbslam.')) or m == 'kbslam'))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=tmp_path, env=env, timeout=180)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["[None,", "None]", "[]"], r.stdout


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_pick_device_raises_without_cuda(monkeypatch):
    _no_cuda(monkeypatch)
    for name in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="CUDA"):
            pick_device(name)
    assert pick_device("cpu") == torch.device("cpu")


def test_slam_without_device_raises_without_cuda(monkeypatch):
    _no_cuda(monkeypatch)
    seq = synthetic.render_sequence(num_frames=1, height=48, width=64)
    cfg = config.tiny_config(48, 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        SLAM(cfg, seq.K, device=None)
    assert SLAM(cfg, seq.K, device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("extra", [[], ["--chunk", "4", "--ba", "off"]])
def test_cli_without_device_asks_for_cuda(monkeypatch, extra):
    """The CLI's default device is the card: on a machine without one it
    fails instead of tracking on the CPU, per frame and chunked."""
    from kbslam_torch import cli

    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--frames", "1", "--width", "64", "--height", "48",
                  *extra])
