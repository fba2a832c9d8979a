"""ZMQ RGB-D camera ingress and its test-double publisher: the port's own
copy of kbslam/io/zmq_camera.py, equal to it below this docstring but for
the package name of its one import (``kbslam_torch.io.proto``). It is
host code (numpy, ``struct``, pyzmq and, for the proto wire format,
protobuf), so the port's copy needs no JAX.

Structural parity with the reference's Camera component (Camera.cpp):
  - SUB socket connected to tcp://localhost:5555 (Camera.cpp:9,29)
  - intrinsics handshake on topic "camera/intrinsics" (two frames:
    topic + payload; empty payload = fatal, Camera.cpp:31-47)
  - frames on topic "camera/rgbd" as a multipart message: part 1 rgb,
    part 2 depth, part 3 mask (Camera.cpp:55-91); an empty frame list
    signals "no frame" and the consumer returns None (Camera.cpp:57-68)
  - a background capture thread keeps only the LATEST complete triple
    in a condvar-guarded mailbox; grab_frames() blocks for it
    (Camera.cpp:14-16, 95-106)

Two wire formats, auto-detected on receive:

  - "raw": little-endian header + raw array bytes (``_pack``/``_unpack``),
    the default;
  - "proto": the protobuf messages of ``kbslam_torch/io/proto/
    as_camera.proto``, a byte-equal copy of the reference package's
    schema (proto package ``kbslam.aswire``), so a camera manager speaks
    one wire format to both packages.

Topics, socket pattern and multipart structure match the reference in
both formats.
"""
from __future__ import annotations

import json
import time
import struct
import threading
from typing import Optional, Tuple

import numpy as np

INTRINSICS_TOPIC = b"camera/intrinsics"
RGBD_TOPIC = b"camera/rgbd"
DEFAULT_ENDPOINT = "tcp://localhost:5555"

_DTYPES = {0: np.uint8, 1: np.uint16}
_DTYPE_CODES = {np.dtype(np.uint8): 0, np.dtype(np.uint16): 1}

# OpenCV type codes used by the proto Image message (what cv::Mat would
# carry through as-serializers): CV_8UC1=0, CV_16UC1=2, CV_8UC3=16.
_CV_TYPES = {0: (np.uint8, 1), 2: (np.uint16, 1), 16: (np.uint8, 3)}
_CV_CODES = {(np.dtype(np.uint8), 1): 0, (np.dtype(np.uint16), 1): 2,
             (np.dtype(np.uint8), 3): 16}


def _pb2():
    from kbslam_torch.io.proto import as_camera_pb2

    return as_camera_pb2


def _pack(img: np.ndarray) -> bytes:
    """Header: u32 h, u32 w, u8 channels, u8 dtype code; then raw bytes."""
    img = np.ascontiguousarray(img)
    c = 1 if img.ndim == 2 else img.shape[2]
    return (
        struct.pack("<IIBB", img.shape[0], img.shape[1], c,
                    _DTYPE_CODES[img.dtype])
        + img.tobytes()
    )


def _pack_proto(img: np.ndarray) -> bytes:
    img = np.ascontiguousarray(img)
    c = 1 if img.ndim == 2 else img.shape[2]
    return _pb2().Image(
        rows=img.shape[0], cols=img.shape[1],
        type=_CV_CODES[(img.dtype, c)], data=img.tobytes()
    ).SerializeToString()


def _unpack(buf: bytes) -> np.ndarray:
    """Decode an image payload, auto-detecting raw vs proto framing.

    The raw header is self-validating (payload length must equal
    10 + h*w*c*itemsize exactly), so raw frames can never fall through
    to the proto parser; proto frames fail that length check and are
    parsed as the Image message (validated against rows*cols*elemSize)."""
    if len(buf) >= 10:
        h, w, c, code = struct.unpack("<IIBB", buf[:10])
        if code in _DTYPES and len(buf) == 10 + h * w * c * np.dtype(
                _DTYPES[code]).itemsize:
            arr = np.frombuffer(buf[10:], dtype=_DTYPES[code])
            return arr.reshape((h, w) if c == 1 else (h, w, c))
    msg = _pb2().Image.FromString(bytes(buf))
    if msg.type not in _CV_TYPES:
        raise ValueError(f"unsupported OpenCV type code {msg.type}")
    dtype, c = _CV_TYPES[msg.type]
    expect = msg.rows * msg.cols * c * np.dtype(dtype).itemsize
    if len(msg.data) != expect:
        raise ValueError(
            f"proto Image data size {len(msg.data)} != {expect} "
            f"({msg.rows}x{msg.cols} type {msg.type})")
    arr = np.frombuffer(msg.data, dtype=dtype)
    return arr.reshape((msg.rows, msg.cols) if c == 1
                       else (msg.rows, msg.cols, c))


def _unpack_intrinsics(buf: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """JSON (raw format) or proto Intrinsics -> (K 3x3, dist 5)."""
    if buf[:1] == b"{":
        meta = json.loads(buf)
        return (np.asarray(meta["K"], np.float64),
                np.asarray(meta.get("dist", [0] * 5), np.float64))
    m = _pb2().Intrinsics.FromString(bytes(buf))
    K = np.array([[m.fx, 0, m.ppx], [0, m.fy, m.ppy], [0, 0, 1.0]])
    # Keep the coefficient vector at full length (padded to >= 5): an
    # 8-coefficient rational model must reach Intrinsics.from_matrix's
    # unsupported-model guard (geom/camera.py), not be silently cut to 5
    # here — that would undistort with wrong geometry and no error.
    coeffs = [float(c) for c in m.coeffs]
    dist = np.zeros(max(5, len(coeffs)))
    dist[:len(coeffs)] = coeffs
    return K, dist


class ZMQCamera:
    """Blocking-latest-frame camera, mirroring the reference Camera class."""

    def __init__(self, endpoint: str = DEFAULT_ENDPOINT, timeout_s: float = 30.0):
        import zmq

        self._ctx = zmq.Context.instance()
        self._timeout_s = timeout_s
        self._endpoint = endpoint
        self._lock = threading.Condition()
        self._frames: Optional[tuple] = None
        self._eof = False
        self._K: Optional[np.ndarray] = None
        self._dist: Optional[np.ndarray] = None
        self._k_ready = threading.Event()
        self._error: Optional[BaseException] = None
        self._run = True
        self._thread = threading.Thread(target=self._capture, daemon=True)
        self._thread.start()

    # Camera::Capture (Camera.cpp:26-93)
    def _capture(self):
        import zmq

        sock = self._ctx.socket(zmq.SUB)
        sock.connect(self._endpoint)
        sock.setsockopt(zmq.SUBSCRIBE, INTRINSICS_TOPIC)
        sock.setsockopt(zmq.SUBSCRIBE, RGBD_TOPIC)
        poller = zmq.Poller()
        poller.register(sock, zmq.POLLIN)
        try:
            self._capture_loop(sock, poller)
        except BaseException as e:  # noqa: BLE001 — surfaced to consumers
            # A malformed payload (e.g. a publisher speaking a different
            # as-serializers schema variant) must not die silently in this
            # daemon thread and present as a generic timeout downstream:
            # record it so grab_frames/get_intrinsics re-raise with cause.
            with self._lock:
                self._error = e
                self._lock.notify_all()
            self._k_ready.set()
        finally:
            # the socket lives and dies on the capture thread (zmq
            # sockets are not thread-safe); close() only signals + joins
            sock.close(0)

    def _capture_loop(self, sock, poller):
        while self._run:
            # short poll slices so close() is honored promptly
            if not poller.poll(min(int(self._timeout_s * 1000), 250)):
                continue
            parts = sock.recv_multipart()
            topic = parts[0]
            if topic == INTRINSICS_TOPIC:
                if len(parts) < 2 or not parts[1]:
                    raise RuntimeError(
                        "empty intrinsics payload (reference exits here, "
                        "Camera.cpp:35-39)")
                self._K, self._dist = _unpack_intrinsics(parts[1])
                self._k_ready.set()
            elif topic == RGBD_TOPIC:
                with self._lock:
                    if len(parts) < 4 or not parts[1]:
                        # empty message: end-of-stream marker
                        self._frames = None
                        self._eof = True
                    else:
                        rgb = _unpack(parts[1])
                        depth = _unpack(parts[2])
                        mask = _unpack(parts[3])
                        self._frames = (rgb, depth, mask)
                    self._lock.notify()

    # Camera::GrabFrames (Camera.cpp:95-106)
    def grab_frames(self, timeout: Optional[float] = None
                    ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Blocks for the next frame; None means END OF STREAM (the
        reference's empty-message marker) — a publisher stall raises
        TimeoutError instead so callers can distinguish the two (the
        reference's condvar wait simply blocks forever on a stall)."""
        deadline = time.monotonic() + (timeout or self._timeout_s)
        with self._lock:
            while self._frames is None and not self._eof:
                if self._error is not None:
                    raise RuntimeError(
                        "camera capture thread failed while decoding a "
                        "payload") from self._error
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"no frame within {timeout or self._timeout_s:.1f}s "
                        "and no end-of-stream marker")
                self._lock.wait(remaining)
            frames = self._frames
            self._frames = None
            return frames

    # Camera::getIntrinsics (Camera.cpp:108-124)
    def get_intrinsics(self) -> Tuple[np.ndarray, np.ndarray]:
        if not self._k_ready.wait(self._timeout_s):
            raise TimeoutError("no intrinsics received")
        if self._K is None:
            raise RuntimeError(
                "camera capture thread failed before intrinsics arrived"
            ) from self._error
        return self._K, self._dist

    def close(self):
        """Join the capture thread and release the socket (the reference
        Camera's shutdown contract: Camera.cpp destructor joins capture)."""
        self._run = False
        self._thread.join(timeout=self._timeout_s)
        with self._lock:
            self._eof = True
            self._lock.notify_all()  # unblock grab_frames waiters


class FramePublisher:
    """Test double for the external camera-manager process the reference
    implicitly depends on (SURVEY §4): publishes intrinsics then frames
    over the same topics/socket pattern."""

    def __init__(self, endpoint: str = "tcp://*:5555", wire: str = "raw"):
        """wire: "raw" (header+bytes) or "proto" (the best-effort
        as-serializers protobuf schema — what a reference-ecosystem
        camera-manager would speak)."""
        import zmq

        assert wire in ("raw", "proto")
        self._ctx = zmq.Context.instance()
        self._sock = self._ctx.socket(zmq.PUB)
        self._sock.bind(endpoint)
        self._wire = wire

    def publish_intrinsics(self, K: np.ndarray, dist=None):
        K = np.asarray(K, np.float64)
        d = list(dist) if dist is not None else [0.0] * 5
        if self._wire == "proto":
            payload = _pb2().Intrinsics(
                fx=K[0, 0], fy=K[1, 1], ppx=K[0, 2], ppy=K[1, 2],
                coeffs=[float(c) for c in d]).SerializeToString()
        else:
            payload = json.dumps({"K": K.tolist(),
                                  "dist": [float(c) for c in d]}).encode()
        self._sock.send_multipart([INTRINSICS_TOPIC, payload])

    def publish_frame(self, rgb, depth, mask=None):
        if mask is None:
            mask = np.full(rgb.shape[:2], 255, np.uint8)
        pack = _pack_proto if self._wire == "proto" else _pack
        self._sock.send_multipart(
            [RGBD_TOPIC, pack(rgb), pack(depth), pack(mask)]
        )

    def publish_end(self):
        self._sock.send_multipart([RGBD_TOPIC, b""])

    def close(self):
        self._sock.close(0)
