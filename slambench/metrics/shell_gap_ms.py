"""``shell_gap_ms``: device ms of a ``SLAM.process`` frame in which no
marked work ran: from the frame's first device mark to its last, less
the upload's marks and each replayed graph's first-to-last span; the
median over the traced frames (``track_frontend_ms``)."""
from slambench.harness import manifest
from slambench.harness.report import median

_base = manifest.load_module("metrics", "track_frontend_ms")


def read(layer, records=None):
    frames = {}
    for r in _base.program_records(records):
        if r["kind"] == "marks" and r["clock"] == "device":
            frames.setdefault(r["frame"], []).append(r)
    gaps = [(max(r["end_ns"] for r in rs) - min(r["start_ns"] for r in rs)
             - sum(r["end_ns"] - r["start_ns"] for r in rs)) / 1e6
            for rs in frames.values() if any(r["name"] == "shell" for r in rs)]
    return median(gaps) if gaps else None
