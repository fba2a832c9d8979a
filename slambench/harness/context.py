"""What a driver is given and what it returns."""
from __future__ import annotations

from typing import NamedTuple, Optional

from slambench.harness import manifest


class Context(NamedTuple):
    """What a driver gets: the cell, the run's arguments and the device.
    ``overrides`` (tests) replaces keys of the configuration's sections;
    ``control`` also reads the control (``harness/control.py``)."""

    cell: manifest.Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    overrides: Optional[dict] = None
    control: bool = False


class Result(NamedTuple):
    """What a driver returns (``metrics``: end-to-end values by name;
    ``numbers``: the compared numbers; ``layer``: what the metric readers
    read; ``info``: lines for standard error; ``control_numbers``: with
    ``Context.control``, the numbers of the control against the
    reference on the same states)."""

    metrics: dict
    attempted: int
    failed: int
    numbers: dict
    memory_peak_bytes: int
    layer: dict
    info: list
    control_numbers: Optional[dict] = None
