"""``shell_syncs``: blocking host reads ``SLAM.process`` made in a frame
(the counter ``shell.syncs``), the median over the traced frames
(``track_frontend_ms``)."""
from slambench.harness import manifest
from slambench.harness.report import median

_base = manifest.load_module("metrics", "track_frontend_ms")


def read(layer, records=None):
    recs = _base.program_records(records)
    per = {r["frame"]: 0 for r in recs
           if r["kind"] == "span" and r["name"] == "shell.process"}
    for r in recs:
        if r["kind"] == "count" and r["name"] == "shell.syncs" \
                and r["frame"] in per:
            per[r["frame"]] += r["n"]
    return median(per.values()) if per else None
