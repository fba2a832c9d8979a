"""``local_ba_device_ms``: kernel time of one local BA solve (the second
graph a solve frame replays, ``SLAM.graphs["ba"]``), the median over the
traced solve frames; nothing when the stretch held no solve."""
from slambench.harness.report import median


def read(layer):
    p = layer.get("profile")
    if p is None:
        return None
    v = [s.graph_launches()[1].device_ms for s in p.spans
         if s.kind == "frame" and s.index in layer["ba_frames"]
         and len(s.graph_launches()) > 1]
    return median(v) if v else None
