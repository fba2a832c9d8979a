"""``dispatch_host_ms``: host time of a ``feed`` that dispatches a chunk
(staging, the upload, the replay's launch, draining the chunk before),
the median over traced dispatches."""
from slambench.harness.report import median


def read(layer):
    p = layer.get("profile")
    if p is None:
        return None
    v = [s.wall_ms for s in p.spans if s.kind == "dispatch"]
    return median(v) if v else None
