"""A cell cut to a size the CPU runs in seconds, for the benchmark's own
tests: 160x120 frames, a small ORB and map, two streams, short check
stretches. The traffic mix and the limits are the cell's own."""
from __future__ import annotations

import json

import torch

from slambench.harness import manifest
from slambench.harness.context import Context

CONFIG = {"streams": 2,
          "camera": {"width": 160, "height": 120, "fx": 130.0},
          "slam": {"image_height": 120, "image_width": 160,
                   "orb": {"num_features": 300, "num_levels": 4,
                           "max_features": 320},
                   "map": {"max_keyframes": 8, "max_map_points": 2048}}}
CHECK = {"live": {"stretches": 2, "stretch_frames": 12},
         "fleet": {"stretches": 1, "stretch_steps": 12, "streams": 2,
                   "within_steps": 24},
         "chunked": {"chunks": 2, "within_chunks": 8}}
TRACE = {"live": {"frames": 10}, "fleet": {"start": 4, "steps": 3},
         "chunked": {"start": 3, "chunks": 1}}


def context(name: str, seed: int = 5, seconds: float = 1.0,
            control: bool = False) -> Context:
    """The cell ``name`` at the tiny size, on the CPU."""
    cell = manifest.load_cell(name)
    traffic = json.loads(json.dumps(cell.traffic))
    driver = traffic["driver"]
    traffic["check"].update(CHECK[driver])
    traffic["trace"] = TRACE[driver]
    for key in ("warmup_frames", "warmup_steps", "warmup_chunks"):
        if key in traffic:
            traffic[key] = 2
    return Context(cell._replace(traffic=traffic), seed, seconds, False,
                   torch.device("cpu"), CONFIG, control)


def run(ctx: Context, **driver_kw):
    """(correct, the driver's result) of one tiny run."""
    from slambench.harness.compare import judge

    driver = manifest.load_module("drivers", ctx.cell.traffic["driver"])
    res = driver.run(ctx, **driver_kw)
    return judge(res.numbers, ctx.cell.traffic["check"]["limits"])[0], res
