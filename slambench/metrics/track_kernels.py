"""``track_kernels``: kernels one replay of the tracking step runs, the
median over traced frames."""
from slambench.harness.report import median


def read(layer):
    p = layer.get("profile")
    if p is None:
        return None
    v = [s.graph_launches()[0].count() for s in p.spans
         if s.kind == "frame" and s.graph_launches()]
    return median(v) if v else None
