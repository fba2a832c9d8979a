"""The port's ingress and egress against the JAX reference.

- The ZMQ camera (``kbslam_torch/io/zmq_camera.py``, a copy): the cases
  of tests/test_io.py on the port's module (raw and proto round trips,
  close, decode errors, the proto intrinsics and the image codec), and a
  camera of each package decoding the other's publisher, raw and proto:
  one wire format for both.
- The viewer (``kbslam_torch/viz/rerun_viewer.py``, a copy; a recorder
  without the rerun SDK): the schema, JET and blueprint cases of
  tests/test_io.py and tests/test_utils.py; ``to_display_coords`` equal
  to the reference's to the bit.
- ``kbslam_torch/utils``: the logging cases of tests/test_utils.py, and
  ``device_trace`` writing a trace on the CPU.
- ``python -m kbslam_torch.cli --source zmq:<endpoint>`` fed by a
  ``FramePublisher`` thread, per frame and chunked.

Every socket binds a port the system picks (``tcp://127.0.0.1:*``), so
the file runs beside tests/test_io.py, whose ports are fixed.
"""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _publisher(mod, wire="raw"):
    """(publisher of module ``mod`` on a free port, its endpoint)."""
    import zmq

    pub = mod.FramePublisher("tcp://127.0.0.1:*", wire=wire)
    return pub, pub._sock.getsockopt(zmq.LAST_ENDPOINT).decode()


def _handshake(pub, cam, K, dist=None):
    """Publish the intrinsics until the subscriber has joined."""
    for _ in range(50):
        pub.publish_intrinsics(K, dist=dist)
        try:
            return cam.get_intrinsics()
        except TimeoutError:
            continue
    raise AssertionError("no intrinsics handshake")


def _round_trip(pub_mod, cam_mod, wire):
    pub, ep = _publisher(pub_mod, wire)
    cam = cam_mod.ZMQCamera(ep, timeout_s=0.2)
    try:
        K = np.array([[525.0, 0, 319.5], [0, 525.0, 239.5], [0, 0, 1]])
        rng = np.random.default_rng(2)
        rgb = rng.integers(0, 255, (60, 80, 3), dtype=np.uint8)
        depth = rng.integers(0, 5000, (60, 80), dtype=np.uint16)
        mask = (rng.random((60, 80)) > 0.5).astype(np.uint8) * 255
        got_K, dist = _handshake(pub, cam, K, dist=[0.25, 0, 0, 0, 0])
        np.testing.assert_allclose(got_K, K)
        np.testing.assert_allclose(dist, [0.25, 0, 0, 0, 0])
        pub.publish_frame(rgb, depth, mask)
        frames = cam.grab_frames(timeout=5.0)
        assert frames is not None
        for got, want in zip(frames, (rgb, depth, mask)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        # end-of-stream marker -> None (the reference's empty message)
        pub.publish_end()
        assert cam.grab_frames(timeout=2.0) is None
    finally:
        cam.close()
        pub.close()


@pytest.mark.parametrize("wire", ["raw", "proto"])
def test_zmq_round_trip(wire):
    """tests/test_io.py:62 and :265 on the port's camera and publisher."""
    pytest.importorskip("zmq")
    if wire == "proto":
        pytest.importorskip("google.protobuf")
    from kbslam_torch.io import zmq_camera

    _round_trip(zmq_camera, zmq_camera, wire)


@pytest.mark.parametrize("wire", ["raw", "proto"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_zmq_wire_shared_with_reference(direction, wire):
    """A camera of each package decodes the other's publisher: one wire
    format (and, for proto, one registered schema) for both."""
    pytest.importorskip("zmq")
    if wire == "proto":
        pytest.importorskip("google.protobuf")
    from kbslam.io import zmq_camera as jzmq
    from kbslam_torch.io import zmq_camera as tzmq

    pub, cam = (jzmq, tzmq) if direction == "jax_to_port" else (tzmq, jzmq)
    _round_trip(pub, cam, wire)
    if wire == "proto":
        # identical descriptors: both packages build the same classes
        assert tzmq._pb2().Image is jzmq._pb2().Image


def test_proto_schema_bytes_equal_reference():
    pytest.importorskip("google.protobuf")
    from kbslam.io.proto import as_camera_pb2 as j
    from kbslam_torch.io.proto import as_camera_pb2 as t

    assert t.DESCRIPTOR.serialized_pb == j.DESCRIPTOR.serialized_pb
    assert t.DESCRIPTOR.package == "kbslam.aswire"


def test_zmq_close_joins_capture_thread():
    """tests/test_io.py:230."""
    pytest.importorskip("zmq")
    from kbslam_torch.io import zmq_camera

    pub, ep = _publisher(zmq_camera)
    cam = zmq_camera.ZMQCamera(ep, timeout_s=5.0)
    t0 = time.time()
    cam.close()
    pub.close()
    assert not cam._thread.is_alive()
    assert time.time() - t0 < 3.0  # poll slice, not the full timeout
    # a consumer arriving after close is not blocked
    assert cam.grab_frames(timeout=0.5) is None


def test_proto_intrinsics_full_coeffs_reach_model_guard():
    """tests/test_io.py:309 with the port's Intrinsics."""
    pytest.importorskip("google.protobuf")
    from kbslam_torch.geom.camera import Intrinsics
    from kbslam_torch.io.zmq_camera import _pb2, _unpack_intrinsics

    buf = _pb2().Intrinsics(
        fx=525.0, fy=525.0, ppx=319.5, ppy=239.5,
        coeffs=[0.1, -0.2, 0.0, 0.0, 0.05, 0.3, 0.01, 0.002],
    ).SerializeToString()
    K, dist = _unpack_intrinsics(buf)
    assert len(dist) == 8 and dist[5] == 0.3
    with pytest.raises(ValueError, match="unsupported distortion model"):
        Intrinsics.from_matrix(K, dist)
    buf5 = _pb2().Intrinsics(fx=525.0, fy=525.0, ppx=319.5, ppy=239.5,
                             coeffs=[0.1, -0.2, 0.0, 0.0, 0.05, 0.0, 0.0, 0.0]
                             ).SerializeToString()
    K5, dist5 = _unpack_intrinsics(buf5)
    assert Intrinsics.from_matrix(K5, dist5).dist == (0.1, -0.2, 0.0, 0.0,
                                                       0.05)


def test_zmq_capture_decode_error_surfaces():
    """tests/test_io.py:335."""
    pytest.importorskip("zmq")
    from kbslam_torch.io import zmq_camera

    pub, ep = _publisher(zmq_camera)
    cam = zmq_camera.ZMQCamera(ep, timeout_s=0.2)
    try:
        _handshake(pub, cam, np.eye(3) * 100.0)
        # garbage that fails both the raw length check and the proto parse
        pub._sock.send_multipart([zmq_camera.RGBD_TOPIC, b"\xff" * 37,
                                  b"\xff", b"\xff"])
        with pytest.raises(RuntimeError, match="capture thread failed"):
            cam.grab_frames(timeout=5.0)
    finally:
        cam.close()
        pub.close()


def test_proto_image_pack_unpack_all_types():
    """tests/test_io.py:361, and the port's frames decode in the
    reference's codec and back."""
    from kbslam.io import zmq_camera as j
    from kbslam_torch.io import zmq_camera as t

    rng = np.random.default_rng(7)
    for arr in (rng.integers(0, 255, (33, 41, 3), dtype=np.uint8),
                rng.integers(0, 9000, (33, 41), dtype=np.uint16),
                rng.integers(0, 2, (33, 41), dtype=np.uint8)):
        np.testing.assert_array_equal(t._unpack(t._pack(arr)), arr)
        assert t._pack(arr) == j._pack(arr)
        np.testing.assert_array_equal(j._unpack(t._pack(arr)), arr)
        np.testing.assert_array_equal(t._unpack(t._pack_proto(arr)), arr)
        assert t._pack_proto(arr) == j._pack_proto(arr)


def test_viewer_noop_schema():
    """tests/test_io.py:104 on the port's viewer and mesh."""
    from kbslam_torch.mapping.mesh import TriangleMesh
    from kbslam_torch.viz.rerun_viewer import Viewer

    v = Viewer(spawn=False)
    traj = np.array([[1.0, 2.0, 3.0]])
    v.update(traj, traj, traj)
    np.testing.assert_allclose(v.last["trajectory"], [[1.0, -3.0, -2.0]])
    v.update_dense(traj)
    np.testing.assert_allclose(v.last["dense"], [[1.0, -3.0, -2.0]])
    mesh = TriangleMesh(
        vertices=np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32),
        faces=np.array([[0, 1, 2]], np.int32))
    v.update_dense_mesh(mesh)
    mv, mf = v.last["dense_mesh"]
    np.testing.assert_allclose(mv, [[0, 0, 0], [1, 0, 0], [0, 0, -1]])
    np.testing.assert_array_equal(mf, [[0, 2, 1]])
    n_orig = np.cross(mesh.vertices[1] - mesh.vertices[0],
                      mesh.vertices[2] - mesh.vertices[0])
    n_disp = np.cross(mv[mf[0, 1]] - mv[mf[0, 0]],
                      mv[mf[0, 2]] - mv[mf[0, 0]])
    np.testing.assert_allclose(n_disp, [n_orig[0], -n_orig[2], -n_orig[1]])


def test_viewer_depth_jet_colorize():
    """tests/test_io.py:243, and the port's colours equal the
    reference's."""
    from kbslam.viz import rerun_viewer as j
    from kbslam_torch.viz.rerun_viewer import (Viewer, colorize_depth,
                                               jet_colormap)

    ramp = jet_colormap(np.array([[0, 128, 255]], np.uint8))[0]
    assert ramp[0][2] > 100 and ramp[0][0] == 0      # blue end
    assert ramp[1][1] > 200                          # green middle
    assert ramp[2][0] > 100 and ramp[2][2] == 0      # red end
    depth = np.full((4, 4), 3000, np.uint16)         # 3 m at mm scale
    v = Viewer(spawn=False, depth_display_alpha=0.02)
    v.update(np.zeros((1, 3)), np.zeros((1, 3)), np.zeros((1, 3)),
             depth=depth)
    img = v.last["depth_rgb"]
    assert img.shape == (4, 4, 3) and img.dtype == np.uint8
    np.testing.assert_array_equal(img, colorize_depth(depth, 0.02))
    assert img[0, 0, 2] > img[0, 0, 0]
    ramp_all = np.arange(256, dtype=np.uint8)[None]
    np.testing.assert_array_equal(jet_colormap(ramp_all),
                                  j.jet_colormap(ramp_all))


def test_blueprint_spec_binds_to_reference_rbl(monkeypatch):
    """tests/test_io.py:374 on the port's blueprint: that test's own body
    (and its blueprint file; it skips where the file is absent) with the
    reference module's names bound to the port's."""
    import test_io
    from kbslam.viz import rerun_viewer as j
    from kbslam_torch.viz import rerun_viewer as t

    for name in ("BLUEPRINT_SPEC", "LOGGED_PATHS",
                 "scan_blueprint_entity_paths"):
        monkeypatch.setattr(j, name, getattr(t, name))
    test_io.test_blueprint_spec_binds_to_reference_rbl()


def test_blueprint_spec_matches_reference_entity_paths():
    """tests/test_utils.py's blueprint case on the port's viewer."""
    from kbslam.viz import rerun_viewer as j
    from kbslam_torch.viz.rerun_viewer import (BLUEPRINT_SPEC, HAVE_RERUN,
                                               LOGGED_PATHS, make_blueprint)

    assert BLUEPRINT_SPEC["world"]["origin"] == "/world"
    for feed in ("rgb", "depth", "mask"):
        assert BLUEPRINT_SPEC[feed]["origin"] == f"/camera/0/{feed}"
    assert (make_blueprint() is None) == (not HAVE_RERUN)
    assert BLUEPRINT_SPEC == j.BLUEPRINT_SPEC
    assert LOGGED_PATHS == j.LOGGED_PATHS


def test_to_display_coords_matches_reference():
    import jax.numpy as jnp

    from kbslam.geom.camera import to_display_coords as jdisp
    from kbslam_torch.geom.camera import to_display_coords as tdisp

    p = np.random.default_rng(3).normal(size=(2, 5, 3)).astype(np.float32)
    got = tdisp(torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jdisp(jnp.asarray(p))))
    assert got.shape == p.shape and got.dtype == np.float32


def test_logging_gated(capsys, monkeypatch):
    """tests/test_utils.py's logging case on the port's copy."""
    from kbslam_torch.utils.logging import error, info, log

    monkeypatch.delenv("KBSLAM_DEBUG", raising=False)
    log("hidden")
    info("hidden")
    error("shown")
    cap = capsys.readouterr()
    assert "hidden" not in cap.out
    assert "shown" in cap.err
    monkeypatch.setenv("KBSLAM_DEBUG", "1")
    info("now visible")
    assert "now visible" in capsys.readouterr().out


def test_device_trace_writes_a_cpu_trace(tmp_path):
    """``device_trace(device="cpu")`` yields its directory and writes a
    Chrome trace of the block's operators there."""
    from kbslam_torch.utils.profiling import TRACE_FILE, device_trace

    with device_trace(str(tmp_path / "trace"), device="cpu") as d:
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    assert d == str(tmp_path / "trace")
    with open(os.path.join(d, TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


# --- the CLI's zmq source ---------------------------------------------------

SMALL = ["--width", "160", "--height", "120", "--device", "cpu"]
N_FRAMES = 8


class _Feeder(threading.Thread):
    """Publishes the handshake until a camera holds the intrinsics, then
    one frame at a time, each once the camera has handed the previous
    one out (the camera keeps only the latest frame), then the end
    marker."""

    def __init__(self, monkeypatch, seq, wire="raw"):
        super().__init__(daemon=True)
        from kbslam_torch.io import zmq_camera

        self.pub, self.endpoint = _publisher(zmq_camera, wire)
        self.seq, self.cams = seq, []
        self.grabbed = threading.Semaphore(0)
        self.error = None
        init, grab = zmq_camera.ZMQCamera.__init__, \
            zmq_camera.ZMQCamera.grab_frames

        def init_(cam, *a, **k):
            init(cam, *a, **k)
            self.cams.append(cam)

        def grab_(cam, *a, **k):
            try:
                return grab(cam, *a, **k)
            finally:
                self.grabbed.release()
        monkeypatch.setattr(zmq_camera.ZMQCamera, "__init__", init_)
        monkeypatch.setattr(zmq_camera.ZMQCamera, "grab_frames", grab_)

    def run(self):
        try:
            deadline = time.monotonic() + 30
            while not (self.cams and self.cams[0]._k_ready.is_set()):
                assert time.monotonic() < deadline, "no camera joined"
                self.pub.publish_intrinsics(self.seq.K)
                time.sleep(0.05)
            for i in range(len(self.seq.rgb)):
                self.pub.publish_frame(self.seq.rgb[i], self.seq.depth[i])
                assert self.grabbed.acquire(timeout=60), f"frame {i}"
            self.pub.publish_end()
        except BaseException as e:  # noqa: BLE001 - re-raised by the test
            self.error = e


def _zmq_cli(monkeypatch, capsys, seq, extra):
    from kbslam_torch import cli

    feeder = _Feeder(monkeypatch, seq)
    feeder.start()
    try:
        cli.main(["--source", f"zmq:{feeder.endpoint}", *SMALL, *extra])
    finally:
        feeder.join(timeout=60)
        feeder.pub.close()
    assert not feeder.is_alive() and feeder.error is None, feeder.error
    assert not feeder.cams[0]._thread.is_alive()   # the CLI closed it
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("extra,keys", [
    ([], {"frames", "success", "keyframes", "ba_runs", "mean_track_ms"}),
    (["--chunk", "4", "--ba", "off"],
     {"frames", "success", "keyframes", "ba_runs", "chunk", "gray_ingress",
      "streaming_fps"})])
def test_cli_zmq_source(monkeypatch, capsys, tmp_path, extra, keys):
    """``--source zmq:<endpoint>`` tracks a publisher's frames to its end
    marker, per frame and chunked: the summary of kbslam/cli.py (the
    keys it writes without ground truth), and the trajectory of the same
    frames given by the synthetic source, to the bit."""
    pytest.importorskip("zmq")
    from kbslam_torch import cli
    from kbslam_torch.io.synthetic import render_sequence

    seq = render_sequence(num_frames=N_FRAMES, height=120, width=160,
                          fx=525.0 * 160 / 640.0)
    traj = str(tmp_path / "zmq.txt")
    s = _zmq_cli(monkeypatch, capsys, seq, [*extra, "--save-trajectory",
                                            traj])
    assert set(s) == keys
    assert s["frames"] == N_FRAMES and s["success"] == N_FRAMES - 1
    ref = str(tmp_path / "synthetic.txt")
    cli.main(["--frames", str(N_FRAMES), *SMALL, *extra,
              "--save-trajectory", ref])
    capsys.readouterr()
    with open(traj) as a, open(ref) as b:
        assert a.read() == b.read()


def test_cli_zmq_distortion_from_the_handshake(monkeypatch, capsys):
    """--dist unset: the handshake's nonzero coefficients are the lens
    model (kbslam/cli.py:172-173); a zero handshake leaves none."""
    pytest.importorskip("zmq")
    from kbslam_torch import slam as slam_mod
    from kbslam_torch.io.synthetic import render_sequence

    seq = render_sequence(num_frames=2, height=120, width=160,
                          fx=525.0 * 160 / 640.0)
    dists = []
    init = slam_mod.SLAM.__init__

    def init_(self, *a, **k):
        init(self, *a, **k)
        dists.append(self.intr.dist)
    monkeypatch.setattr(slam_mod.SLAM, "__init__", init_)
    feeder = _Feeder(monkeypatch, seq)
    pub_intr = feeder.pub.publish_intrinsics
    feeder.pub.publish_intrinsics = lambda K, dist=None: pub_intr(
        K, dist=[0.01, 0.0, 0.0, 0.0, 0.0])
    feeder.start()
    from kbslam_torch import cli
    try:
        cli.main(["--source", f"zmq:{feeder.endpoint}", *SMALL, "--ba", "off"])
    finally:
        feeder.join(timeout=60)
        feeder.pub.close()
    assert not feeder.is_alive() and feeder.error is None, feeder.error
    assert dists == [(0.01, 0.0, 0.0, 0.0, 0.0)]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "frames"] == 2
