"""``ba_lm_ms``: device ms of the ``lm`` stage
(``solve_window_compact``, all its trips) in a replay of the shell's
local-BA graph (``SLAM.graphs["ba"]``), by its stage marks; the median
over the traced solves (``track_frontend_ms``)."""
from slambench.harness import manifest

_base = manifest.load_module("metrics", "track_frontend_ms")


def read(layer, records=None):
    return _base.stage_ms(records, ("ba",), "lm")
