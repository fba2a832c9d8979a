"""``python -m kbslam_torch.cli --viewer rerun`` on the CPU.

Without the rerun SDK the viewer is the reference module's recorder: it
logs nothing and keeps the last logged state (``Viewer.last``). The CLI
feeds it as kbslam/cli.py does: per frame, the trajectory, keyframes,
landmarks and images every ``--viewer-every`` frames and, with
``--dense``, the surface cloud and a stride-4 render on keyframe frames;
chunked, one update per ``--viewer-every`` drained frames and at most
one dense update per as many; the mesh once with ``--save-mesh``.

The viewer only reads: with ``--viewer-every`` 1 and 3, per frame (local
BA on) and chunked (``--chunk 4``), with and without ``--dense``, the
trajectory file and the summary (timings aside) equal those of the same
run with ``--viewer none``, and the recorder's last trajectory is the
display remap (x, -z, -y) of the trajectory up to the last frame it was
given.
"""
import json

import numpy as np
import pytest
import torch

from kbslam_torch import cli
from kbslam_torch.viz import rerun_viewer

torch.set_num_threads(1)
N_FRAMES = 8
SMALL = ["--frames", str(N_FRAMES), "--width", "160", "--height", "120",
         "--device", "cpu"]
TIMINGS = ("mean_track_ms", "streaming_fps")


def _run(capsys, tmp_path, name, args):
    traj = tmp_path / f"{name}.txt"
    cli.main([*SMALL, *args, "--save-trajectory", str(traj)])
    s = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return {k: v for k, v in s.items() if k not in TIMINGS}, traj.read_text()


@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "dense"])
@pytest.mark.parametrize("path", [[], ["--chunk", "4", "--ba", "off"]],
                         ids=["per_frame", "chunked"])
def test_viewer_reads_and_never_writes(path, dense, tmp_path, capsys,
                                       monkeypatch):
    extra = [*path]
    if dense:
        extra += ["--dense", "--save-mesh", str(tmp_path / "m.ply")]
    ref_summary, ref_traj = _run(capsys, tmp_path, "none",
                                 [*extra, "--viewer", "none"])
    positions = np.loadtxt(ref_traj.splitlines())[:, 1:4]

    viewers, calls = [], []
    init = rerun_viewer.Viewer.__init__

    def init_(self, *a, **k):
        init(self, *a, **k)
        viewers.append(self)
    monkeypatch.setattr(rerun_viewer.Viewer, "__init__", init_)
    for method in ("update", "update_dense", "update_rendered",
                   "update_dense_mesh"):
        def counted(self, *a, _m=getattr(rerun_viewer.Viewer, method),
                    _name=method, **k):
            calls.append(_name)
            return _m(self, *a, **k)
        monkeypatch.setattr(rerun_viewer.Viewer, method, counted)

    for every in (1, 3):
        viewers.clear()
        calls.clear()
        summary, traj = _run(capsys, tmp_path, f"every{every}",
                             [*extra, "--viewer", "rerun", "--viewer-every",
                              str(every)])
        assert summary == ref_summary
        assert traj == ref_traj
        assert len(viewers) == 1 and not viewers[0].enabled
        shown = list(range(0, N_FRAMES, every))
        assert calls.count("update") == len(shown)
        last = viewers[0].last
        want = positions[:shown[-1] + 1]
        np.testing.assert_array_equal(
            last["trajectory"],
            np.stack([want[:, 0], -want[:, 2], -want[:, 1]], axis=-1))
        assert last["depth_rgb"].shape == (120, 160, 3)
        if dense:
            assert calls.count("update_dense") == calls.count(
                "update_rendered") >= 1
            assert calls.count("update_dense_mesh") == 1
            # update() starts a new record; the mesh is logged last
            assert len(last["dense_mesh"][0]) > 0
        else:
            assert set(calls) == {"update"}
