"""The arithmetic of the end-to-end metrics, the process clock, and the
run's result line.

The last line of standard output is one JSON object with the keys
``correct``, ``attempted``, ``failed``, ``metrics`` and ``device`` (and,
traced, ``breakdown``), and last ``check``: each number the correctness
comparison read, beside its limit. Everything else goes on earlier
lines, so the last one stays short.
"""
from __future__ import annotations

import json
import math
import os
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "kbslam")


def percentile(values, q: float) -> float:
    """The q-th percentile of every value, by linear interpolation between
    the closest ranks (numpy's default)."""
    v = sorted(float(x) for x in values)
    if not v:
        raise ValueError("percentile of no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def median(values) -> float:
    return percentile(values, 50.0)


def rate(count: int, seconds: float) -> float:
    """Work per second over the whole window."""
    if seconds <= 0:
        raise ValueError("a window of no length")
    return count / seconds


def self_ms(wall_ms: float, child_ms: float) -> float:
    """A span's self time: its wall time less what its children cover."""
    return wall_ms - child_ms


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time of the
    process against the boot clock, which counts from the same zero)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    return (time.clock_gettime(time.CLOCK_BOOTTIME)
            - start_ticks / os.sysconf("SC_CLK_TCK"))


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name, taken whole, is JAX's or the
    JAX package's."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                units: dict, device: dict, check: dict,
                breakdown=None) -> str:
    """The final JSON line; ``check`` maps a compared number's name to
    (value, limit) and comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed),
           "metrics": {k: {"value": float(v), "unit": units[k]}
                       for k, v in metrics.items()},
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["check"] = {k: [float(v), float(lim)] for k, (v, lim) in check.items()}
    return json.dumps(out, separators=(",", ":"))


def check_lines(check: dict) -> list:
    """The compared numbers, one per line, for the end of standard error."""
    return [f"check {k} {float(v)!r} limit {float(lim)!r}"
            for k, (v, lim) in check.items()]
