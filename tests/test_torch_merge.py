"""The port's merge of an asynchronous BA result against the JAX
reference, on the two scenarios of tests/test_async_ba.py: a ring that
advanced past two window slots while the solve ran, and a stale landmark
reference that tracking refilled with a fresh id. The merge only
selects, so every field of the merged map must be equal bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbslam.ba.merge import merge_ba_result as j_merge
from kbslam.config import BAConfig, MapConfig, OrbConfig
from kbslam.geom.se3 import SE3
from kbslam.mapping.state import empty_map, insert_keyframe
from kbslam_torch import config as tconfig
from kbslam_torch import convert
from kbslam_torch.ba.merge import merge_ba_result as t_merge
from tests.test_mapstate import fake_feats

torch.set_num_threads(1)


def _insert(m, rng, tx):
    return insert_keyframe(m, fake_feats(rng), jnp.ones(8),
                           SE3.identity()._replace(t=jnp.array([tx, 0, 0])))


def _ring_advanced():
    """tests/test_async_ba.py:42-81."""
    rng = np.random.default_rng(0)
    snap = empty_map(MapConfig(max_keyframes=4, max_map_points=64),
                     OrbConfig(max_features=8, num_levels=1))
    for i in range(4):
        snap = _insert(snap, rng, float(i))
    ba = snap._replace(kf_t=snap.kf_t + jnp.array([0.0, 10.0, 0.0]),
                       mp_pos=snap.mp_pos.at[5].set(jnp.array([9.0, 9.0, 9.0])))
    snap = snap._replace(kf_mp=snap.kf_mp.at[2, 0].set(5))
    current = snap
    for t in (10.0, 11.0):
        current = _insert(current, rng, t)
    return current, snap, ba


def _stale_reference():
    """tests/test_async_ba.py:84-114."""
    rng = np.random.default_rng(1)
    snap = empty_map(MapConfig(max_keyframes=4, max_map_points=8),
                     OrbConfig(max_features=8, num_levels=1))
    for i in range(3):
        snap = _insert(snap, rng, float(i))
    snap = snap._replace(num_mp=jnp.int32(10))
    snap = snap._replace(kf_mp=snap.kf_mp.at[2, 0].set(1).at[2, 1].set(5))
    ba = snap._replace(kf_mp=snap.kf_mp.at[2, 1].set(-1))
    current = snap._replace(kf_mp=snap.kf_mp.at[2, 0].set(10),
                            num_mp=jnp.int32(11))
    return current, snap, ba


@pytest.mark.parametrize("scenario", [_ring_advanced, _stale_reference])
def test_merge_is_bit_equal(scenario):
    current, snap, ba = scenario()
    jm = jax.device_get(j_merge(current, snap, ba, BAConfig(window=3)))
    maps = [convert.map_to_torch(jax.device_get(m), "cpu")
            for m in (current, snap, ba)]
    tm = convert.map_to_numpy(t_merge(*maps, tconfig.BAConfig(window=3)))
    for name in jm._fields:
        a, b = getattr(tm, name), np.asarray(getattr(jm, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    if scenario is _ring_advanced:
        np.testing.assert_array_equal(tm.kf_t[1:4], [[11.0, 0, 0],
                                                    [2.0, 10.0, 0.0],
                                                    [3.0, 10.0, 0.0]])
    else:
        assert tm.kf_mp[2, 0] == 10 and tm.kf_mp[2, 1] == -1
