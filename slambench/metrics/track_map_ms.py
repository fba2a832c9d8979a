"""``track_map_ms``: device ms of the ``map`` stage (the keyframe
policy, the insertion and landmark fusion) in a replay of the shell's
tracking graph, by its stage marks; the median over the traced frames
(``track_frontend_ms``)."""
from slambench.harness import manifest

_base = manifest.load_module("metrics", "track_frontend_ms")


def read(layer, records=None):
    return _base.stage_ms(records, ("track",), "map")
