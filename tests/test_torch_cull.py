"""The port's keyframe culling (kbslam_torch/mapping/cull.py) against the
JAX reference, on the five cases of tests/test_cull.py: the same inputs
go into both, the keep decisions are bit-equal, and after
``cull_keyframes`` the ring's ``kf_id``, ``kf_kp_valid`` and ``kf_mp``
are equal (integers and booleans, so exactly). The cases' own gates are
held on the port's results too."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation

from kbslam.config import CullConfig, MapConfig, OrbConfig
from kbslam.geom.se3 import SE3
from kbslam.mapping.cull import cull_decision as j_decision
from kbslam.mapping.cull import cull_keyframes as j_cull
from kbslam.mapping.state import empty_map, insert_keyframe
from kbslam_torch import config as tconfig
from kbslam_torch import convert
from kbslam_torch.mapping.cull import cull_decision as t_decision
from kbslam_torch.mapping.cull import cull_keyframes as t_cull
from tests.test_mapstate import fake_feats

torch.set_num_threads(1)
JCFG = CullConfig(enabled=True)
TCFG = tconfig.CullConfig(enabled=True)


def _translations(xyz):
    n = len(xyz)
    return (np.tile([1.0, 0, 0, 0], (n, 1)).astype(np.float32),
            np.asarray(xyz, np.float32))


def _rotations(n):
    q = np.asarray([Rotation.from_rotvec([0, 0.2 * i, 0]).as_quat(
        scalar_first=True) for i in range(n)], np.float32)
    return q, np.zeros((n, 3), np.float32)


CASES = {
    "small_maps_untouched": (_translations([[0, 0, 0], [0.1, 0, 0],
                                            [0.2, 0, 0]]), None),
    "static_middle_culled_but_min_kept": (
        _translations([[0.01 * i, 0, 0] for i in range(8)]),
        [True, False, False, False, True, True, True, True]),
    "moving_keyframes_kept": (
        _translations([[2.0 * i, 0, 0] for i in range(8)]), [True] * 8),
    "rotation_triggers_keep": (_rotations(8), [True] * 8),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cull_decision_matches_reference(case):
    (q, t), want = CASES[case]
    valid = np.ones(len(q), bool)
    j = np.asarray(j_decision(jnp.asarray(q), jnp.asarray(t),
                              jnp.asarray(valid), JCFG))
    got = t_decision(torch.from_numpy(q), torch.from_numpy(t),
                     torch.from_numpy(valid), TCFG).numpy()
    np.testing.assert_array_equal(got, j)
    if want is None:
        assert got.all()        # <= min_keep: the reference returns early
    else:
        np.testing.assert_array_equal(got, want)


def test_cull_keyframes_invalidates_and_cleans_landmarks():
    mcfg = MapConfig(max_keyframes=16, max_map_points=64)
    ocfg = OrbConfig(max_features=8, num_levels=1)
    rng = np.random.default_rng(0)
    m = empty_map(mcfg, ocfg)
    for i in range(8):
        pose = SE3.identity()._replace(t=jnp.array([0.01 * i, 0.0, 0.0]))
        m = insert_keyframe(m, fake_feats(rng), jnp.ones(8), pose)
    # KF1 (culled) holds the only extra observation of landmark 7;
    # landmark 5 is observed by two surviving keyframes
    m = m._replace(
        kf_mp=m.kf_mp.at[1, 0].set(7).at[0, 1].set(5).at[7, 1].set(5))
    tm = convert.map_to_torch(m, "cpu")
    before = tm.kf_id
    out_t = t_cull(tm, TCFG)
    out_j = j_cull(m, JCFG)
    assert out_t.kf_id is before          # invalidated in place
    for name in ("kf_id", "kf_kp_valid", "kf_mp"):
        np.testing.assert_array_equal(getattr(out_t, name).numpy(),
                                      np.asarray(getattr(out_j, name)))
    ids = out_t.kf_id.numpy()
    assert ids[0] == 0 and ids[7] == 7 and (ids >= 0).sum() == 5
    kf_mp = out_t.kf_mp.numpy()
    assert (kf_mp[1] == -1).all()
    assert not (kf_mp == 7).any() and (kf_mp == 5).sum() == 2
