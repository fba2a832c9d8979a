"""``batched_step_device_ms``: kernel time of one replay of the batched
multistream step (one step of every stream), the median over traced
steps."""
from slambench.harness.report import median


def read(layer):
    p = layer.get("profile")
    if p is None:
        return None
    v = [s.graph_launches()[0].device_ms for s in p.spans
         if s.kind == "step" and s.graph_launches()]
    return median(v) if v else None
