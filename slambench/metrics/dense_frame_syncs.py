"""``dense_frame_syncs``: blocking host reads per ``SLAM.process`` frame
(the counter ``shell.syncs``: the track output, a solve's stats, the six
reads of the ICP window's slot choice and the ICP result), the mean over
the traced frames (``track_frontend_ms``)."""
from slambench.harness import manifest

_base = manifest.load_module("metrics", "track_frontend_ms")


def read(layer, records=None):
    recs = _base.program_records(records)
    per = {r["frame"]: 0 for r in recs
           if r["kind"] == "span" and r["name"] == "shell.process"}
    for r in recs:
        if r["kind"] == "count" and r["name"] == "shell.syncs" \
                and r["frame"] in per:
            per[r["frame"]] += r["n"]
    return sum(per.values()) / len(per) if per else None
