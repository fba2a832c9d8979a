"""``step_map_ms``: device ms of the ``map`` stage per tracking step
a graph runs: a batched step of every stream (the multistream step's
graph) or one frame of the chunk graph, by the stage marks inside them;
the median over the traced steps (``track_frontend_ms``)."""
from slambench.harness import manifest

_base = manifest.load_module("metrics", "track_frontend_ms")


def read(layer, records=None):
    return _base.stage_ms(records, ("multistream_step", "chunk"), "map")
