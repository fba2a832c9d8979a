"""``ba_live_trips``: LM trips of a local BA solve before it was done (the
counter ``ba.live_trips``, from the solve's ``BAStats.iterations``; every
solve runs all ``max_iterations``), the median over the traced solves
(``track_frontend_ms``)."""
from slambench.harness import manifest
from slambench.harness.report import median

_base = manifest.load_module("metrics", "track_frontend_ms")


def read(layer, records=None):
    v = [r["n"] for r in _base.program_records(records)
         if r["kind"] == "count" and r["name"] == "ba.live_trips"]
    return median(v) if v else None
