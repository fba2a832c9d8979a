"""The port's checkpoints against the JAX reference's, both ways.

Both packages write the same npz layout (``map.*``, ``track.*``,
``trajectory``, ``meta.*``), so either loads the other's file. Bounds:
a loaded state equals the saved one field by field, bit for bit; a port
run resumed from a file equals, bit for bit, the same run continued
without the file round trip; a reference checkpoint resumed in the port
tracks as the port does from the reference's state in memory.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbslam.geom.camera import Intrinsics as JIntr
from kbslam.io import checkpoint as jckpt
from kbslam.pipeline import init_state as j_init
from kbslam.pipeline import make_track_step as j_make
from kbslam_torch import convert
from kbslam_torch.geom.camera import Intrinsics as TIntr
from kbslam_torch.io import checkpoint as tckpt
from kbslam_torch.pipeline import init_state as t_init
from kbslam_torch.pipeline import make_track_step as t_make
from kbslam_torch.streaming import ChunkedStream
from test_streaming import _cfg
from test_torch_streaming import _keyed_sampler, _seq, _tcfg

torch.set_num_threads(1)
N = 12
SAVE_AT = 8


def _fields(state):
    """Every field of a TrackState (port or reference) as numpy."""
    m = state.map._asdict()
    out = {f"map.{k}": np.asarray(v.cpu() if torch.is_tensor(v) else v)
           for k, v in m.items()}
    for k in ("pose_q", "pose_t", "frames_since_kf", "frame_count"):
        v = getattr(state, k)
        out[f"track.{k}"] = np.asarray(v.cpu() if torch.is_tensor(v) else v)
    return out


def _assert_same_state(a, b):
    fa, fb = _fields(a), _fields(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _track(step, state, seq, frames):
    outs = []
    for i in frames:
        state, o = step(state, torch.from_numpy(seq.rgb[i]),
                        torch.from_numpy(seq.depth[i].astype(np.int32)))
        outs.append([t.numpy().copy() for t in o])
    return outs, state


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The reference tracks SAVE_AT frames and saves a checkpoint."""
    seq = _seq(N)
    step = j_make(_cfg(), JIntr.from_matrix(seq.K), use_mask=False,
                  auto_key=True)
    state = j_init(_cfg())
    for i in range(SAVE_AT):
        state, _ = step(state, jnp.asarray(seq.rgb[i]),
                        jnp.asarray(seq.depth[i]))
    path = str(tmp_path_factory.mktemp("ckpt") / "jax.npz")
    jckpt.save_checkpoint(path, state, trajectory=[np.eye(4)] * SAVE_AT,
                          meta={"ate": 0.25})
    return seq, step, jax.device_get(state), path


def test_reference_checkpoint_resumes_in_the_port(jax_run):
    seq, _, jstate, path = jax_run
    state, traj = tckpt.load_checkpoint(path, _tcfg(), "cpu")
    assert traj.shape == (SAVE_AT, 4, 4)
    _assert_same_state(state, jstate)
    assert int(state.frame_count) == SAVE_AT
    step = t_make(_tcfg(), TIntr.from_matrix(seq.K), use_mask=False,
                  sampler_for_frame=_keyed_sampler)
    resumed, _ = _track(step, state, seq, range(SAVE_AT, N))
    in_memory, _ = _track(step, convert.to_torch(jstate, "cpu"), seq,
                          range(SAVE_AT, N))
    for a, b in zip(resumed, in_memory):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_port_checkpoint_loads_in_the_reference(jax_run, tmp_path):
    """The port resumes the reference's state, tracks on and saves; the
    reference loads that file to the same state and tracks the next
    frame with the same decisions as the port."""
    seq, jstep, jstate, _ = jax_run
    step = t_make(_tcfg(), TIntr.from_matrix(seq.K), use_mask=False,
                  sampler_for_frame=_keyed_sampler)
    _, state = _track(step, convert.to_torch(jstate, "cpu"), seq,
                      range(SAVE_AT, N - 1))
    path = str(tmp_path / "port.npz")
    tckpt.save_checkpoint(path, state, meta={"ate": 0.5, "frames": 11})
    loaded, traj = jckpt.load_checkpoint(path, _cfg())
    assert traj is None
    _assert_same_state(jax.device_get(loaded), state)
    assert jckpt.load_checkpoint_meta(path) == {"ate": 0.5, "frames": 11.0}
    _, jo = jstep(loaded, jnp.asarray(seq.rgb[N - 1]),
                  jnp.asarray(seq.depth[N - 1]))
    (to, ), _ = _track(step, state, seq, [N - 1])
    assert bool(jo.success) == bool(to[2]) and bool(jo.added_kf) == bool(to[3])


def test_resume_equals_the_uninterrupted_stream(tmp_path):
    """A chunked stream saved after two chunks and resumed in a fresh
    stream tracks the remaining frames bit for bit as the stream that
    went on."""
    seq = _seq(N)
    intr = TIntr.from_matrix(seq.K)
    cs = ChunkedStream(_tcfg(), intr, t_init(_tcfg(), "cpu"), chunk=4)
    on = []
    for i in range(N):
        if i == SAVE_AT:
            path = str(tmp_path / "stream.npz")
            tckpt.save_checkpoint(path, cs.state)
        on += cs.feed(seq.rgb[i], seq.depth[i])
    on += cs.flush()
    state, _ = tckpt.load_checkpoint(path, _tcfg(), "cpu")
    fresh = ChunkedStream(_tcfg(), intr, state, chunk=4)
    got = sum([fresh.feed(seq.rgb[i], seq.depth[i])
               for i in range(SAVE_AT, N)], []) + fresh.flush()
    assert len(got) == N - SAVE_AT and len(on) == N
    for a, b in zip(got, on[SAVE_AT:]):
        for k in ("success", "added_kf", "num_inliers", "anchor_id"):
            assert a[k] == b[k]
        np.testing.assert_array_equal(a["pose_q"], b["pose_q"])
        np.testing.assert_array_equal(a["pose_t"], b["pose_t"])
    _assert_same_state(fresh.state, cs.state)


def test_shape_mismatch_is_rejected(jax_run, tmp_path):
    _, _, _, path = jax_run
    other = _tcfg().replace(orb=_tcfg().orb.__class__(
        num_features=256, num_levels=3, max_features=512))
    with pytest.raises(ValueError, match="map.kf_kp_xy"):
        tckpt.load_checkpoint(path, other, "cpu")
    port_path = str(tmp_path / "small.npz")
    tckpt.save_checkpoint(port_path, t_init(_tcfg(), "cpu"))
    with pytest.raises(ValueError):
        jckpt.load_checkpoint(port_path, _cfg().replace(
            map=_cfg().map.__class__(max_keyframes=4, max_map_points=4096)))


def test_meta_round_trip(jax_run, tmp_path):
    _, _, _, path = jax_run
    assert tckpt.load_checkpoint_meta(path) == {"ate": 0.25}
    p = str(tmp_path / "meta.npz")
    tckpt.save_checkpoint(p, t_init(_tcfg(), "cpu"),
                          meta={"rc_median": 0.125, "n": 3})
    assert tckpt.load_checkpoint_meta(p) == {"rc_median": 0.125, "n": 3.0}
    assert jckpt.load_checkpoint_meta(p) == tckpt.load_checkpoint_meta(p)
    with np.load(p) as z:
        assert z["meta.n"].dtype == np.float64
        assert "trajectory" not in z.files


def test_dense_model_is_not_ported_yet(tmp_path):
    """Both dense models are ported now (tests/test_torch_dense.py,
    tests/test_torch_submap_shells.py): a checkpoint written with the
    atlas carries it back, one written without it has none."""
    from kbslam_torch.mapping.submap import empty_atlas

    cfg = _tcfg()
    state = t_init(cfg, "cpu")
    path = str(tmp_path / "x.npz")
    atlas = empty_atlas(cfg.dense, cfg.dense.max_submaps, "cpu")
    tckpt.save_checkpoint(path, state, atlas=atlas, kf_insertions=3)
    back, kf_ins = tckpt.load_checkpoint_atlas(path, cfg, "cpu")
    assert kf_ins == 3 and back.count == 0
    for a, b in zip(back[:5], atlas[:5]):
        assert torch.equal(a, b)
    tckpt.save_checkpoint(path, state)
    assert tckpt.load_checkpoint_atlas(path, cfg, "cpu") == (None, 0)
