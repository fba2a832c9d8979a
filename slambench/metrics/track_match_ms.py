"""``track_match_ms``: device ms of the ``match`` stage (from the end of
``extract_frame`` to the end of the top-M compaction) in a replay of the
shell's tracking graph, by its stage marks; the median over the traced
frames (``track_frontend_ms``)."""
from slambench.harness import manifest

_base = manifest.load_module("metrics", "track_frontend_ms")


def read(layer, records=None):
    return _base.stage_ms(records, ("track",), "match")
