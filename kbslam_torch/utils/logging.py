"""Logging macros: the port's own copy of kbslam/utils/logging.py, equal
to it below this docstring.

The functional twin of the reference's Utils.hpp quartet (LOG/FIX/INFO/
ERROR with ANSI colors, compiled out unless DEBUG): gated by the
``KBSLAM_DEBUG`` environment variable; ERROR always prints.
"""
from __future__ import annotations

import os
import sys

_COLORS = {
    "LOG": "\033[90m",    # gray
    "FIX": "\033[93m",    # yellow — actionable hint, like FIX(...)
    "INFO": "\033[92m",   # green
    "ERROR": "\033[91m",  # red
}
_RESET = "\033[0m"


def _enabled() -> bool:
    return bool(os.environ.get("KBSLAM_DEBUG"))


def _emit(level: str, *args, stream=None):
    if level != "ERROR" and not _enabled():
        return
    stream = stream or (sys.stderr if level == "ERROR" else sys.stdout)
    msg = " ".join(str(a) for a in args)
    print(f"{_COLORS[level]}[{level}]{_RESET} {msg}", file=stream)


def log(*args):
    _emit("LOG", *args)


def fix(*args):
    _emit("FIX", *args)


def info(*args):
    _emit("INFO", *args)


def error(*args):
    _emit("ERROR", *args)
