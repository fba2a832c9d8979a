"""The benchmark's camera: seeded, periodic, at the configuration's
speeds, and equal to the plane scene it was copied from (CPU)."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from slambench.harness import manifest, scene

CONFIGS = [json.loads((manifest.REPO_DIR / c["file"]).read_text())
           for c in manifest.load_manifest()["configs"]]


def _small(cfg, width=128, height=96, period=12):
    cfg = json.loads(json.dumps(cfg))
    cfg["camera"].update(width=width, height=height, fx=width * 0.81)
    cfg["scene"]["period_frames"] = period
    return cfg


def test_frames_repeat_for_a_seed_and_change_with_it():
    cfg = _small(CONFIGS[0])
    a = scene.camera_frames(cfg, 2 ** 31 + 5, torch.device("cpu"), 2)
    b = scene.camera_frames(cfg, 2 ** 31 + 5, torch.device("cpu"), 2)
    c = scene.camera_frames(cfg, 2 ** 31 + 6, torch.device("cpu"), 2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    # stream 1 of seed n is textured as stream 0 of seed n + 1
    assert not torch.equal(a[0][:, 0], a[0][:, 1])


def test_sweep_is_periodic():
    amp = scene.Sweep(**CONFIGS[0]["scene"]["sweep"])
    P = CONFIGS[0]["scene"]["period_frames"]
    np.testing.assert_allclose(scene.sweep_poses(P, amp, phase=P),
                               scene.sweep_poses(P, amp), atol=1e-12)
    shifted = scene.sweep_poses(P, amp, phase=30)
    np.testing.assert_allclose(shifted[:P - 30], scene.sweep_poses(P, amp)[30:],
                               atol=1e-12)


@pytest.mark.parametrize("cfg", CONFIGS, ids=[c["name"] for c in CONFIGS])
def test_sweep_moves_at_the_sequences_speeds_and_stays_on_the_plane(cfg):
    sc, cam = cfg["scene"], cfg["camera"]
    poses = scene.sweep_poses(sc["period_frames"], scene.Sweep(**sc["sweep"]),
                              sc["distance_m"])
    v, w = scene.mean_speeds(poses, cam["hz"])
    assert abs(v / cfg["motion"]["translation_m_per_s"] - 1) < 0.1
    assert abs(w / cfg["motion"]["rotation_deg_per_s"] - 1) < 0.1
    K = scene.intrinsics(cam)
    corners = np.array([[u, v_, 1.0] for u in (0, cam["width"] - 1)
                        for v_ in (0, cam["height"] - 1)])
    rays = corners @ np.linalg.inv(K).T
    for T in poses:
        d = rays @ T[:3, :3].T
        hit = T[:3, 3] + (-T[2, 3] / d[:, 2])[:, None] * d
        assert np.abs(hit[:, :2]).max() < scene.PLANE_EXTENT


def test_render_equals_the_plane_scene_it_copies():
    """The device renderer against ``kbslam_torch.io.synthetic`` on the
    same poses: depth to the millimetre, colour to one level (float32
    rounding of the ray cast)."""
    from kbslam_torch.io.synthetic import render_sequence

    cfg = _small(CONFIGS[0])
    amp = scene.Sweep(**cfg["scene"]["sweep"])
    poses = scene.sweep_poses(4, amp)
    want = render_sequence(4, 96, 128, fx=128 * 0.81, seed=11, poses=poses)
    tex = torch.from_numpy(scene.texture(11))
    rgb, depth = scene.render(tex, torch.from_numpy(poses), 128 * 0.81, 96, 128)
    assert np.abs(depth.numpy() - want.depth.astype(np.int64)).max() <= 1
    diff = np.abs(rgb.numpy().astype(int) - want.rgb.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.05
