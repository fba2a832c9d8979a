"""Changes planted in the program at run time, never in its files: the
faults the check has to catch (the benchmark's tests plant them on the
CPU, ``control.py --plant`` on the card at a cell's own size), and one
look at the asynchronous solve's fault (PERF.md).

Each plant takes a ``setattr(obj, name, value)`` (pytest's
``monkeypatch.setattr``, or Python's own in a process that ends after
the run) and must be planted before the driver builds the program, so
that the captured graphs hold it.
"""
from __future__ import annotations

SHIFT_PX = 1.0      # a principal point off by a pixel: ~4.8 mm at 2.5 m


def ba_dropped(setattr):
    """The per-frame shell's local BA computes its solve and returns its
    stats, but never writes the solve back into the live map."""
    import kbslam_torch.slam as slam
    from kbslam_torch.ba.local_ba import local_ba, stats_vector
    from kbslam_torch.mapping.state import device_copy

    def make(cfg, intr):
        def solve_into(m):
            _, stats = local_ba(device_copy(m), intr, cfg)
            return stats_vector(stats)
        return solve_into
    setattr(slam, "make_local_ba_into", make)


def mp_shifted(setattr):
    """Landmarks made at a keyframe insertion are triangulated with the
    principal point off by ``SHIFT_PX`` (single-stream and batched)."""
    import kbslam_torch.pipeline as pipeline

    for name in ("create_map_points", "create_map_points_batched"):
        real = getattr(pipeline, name)

        def shifted(state, match, fx, fy, cx, cy, *a, _real=real, **kw):
            return _real(state, match, fx, fy, cx + SHIFT_PX, cy, *a, **kw)
        setattr(pipeline, name, shifted)


def solve_own_capture_stream(setattr):
    """Not a fault: the asynchronous local BA's graph captured on a stream
    of its own, so it bakes in a cuBLAS workspace of its own instead of
    the one of torch's shared capture stream, which the chunk graph's
    capture bakes in too."""
    import torch

    import kbslam_torch.ba.local_ba as local_ba
    from kbslam_torch.device import CapturedCall

    class OwnStream(CapturedCall):
        def __init__(self, fn, *args, stream=None, **kw):
            if stream is None:
                stream = torch.cuda.Stream(args[0].kf_q.device)
            super().__init__(fn, *args, stream=stream, **kw)
    setattr(local_ba, "CapturedCall", OwnStream)


PLANTS = {"ba-dropped": ba_dropped, "mp-shifted": mp_shifted,
          "solve-own-capture-stream": solve_own_capture_stream}
