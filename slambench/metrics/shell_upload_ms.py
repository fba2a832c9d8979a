"""``shell_upload_ms``: device ms between the two marks around a frame's
host-to-device copies in ``SLAM.process`` (the stage ``upload`` of the
shell's own marks); the median over the traced frames
(``track_frontend_ms``)."""
from slambench.harness import manifest

_base = manifest.load_module("metrics", "track_frontend_ms")


def read(layer, records=None):
    return _base.stage_ms(records, ("shell",), "upload")
