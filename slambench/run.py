"""The benchmark of kbslam_torch: one run of one cell.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration and
a traffic mix; the traffic mix names its driver (``drivers/<name>.py``),
which sets the program up, renders the frames from the seed, warms up
every program the window replays, measures for ``--seconds``, and then
holds what the window produced to the plain reference
(``harness/compare.py``). Untraced, the result line carries the cell's
end-to-end metrics; traced, its per-layer metrics, each read by
``metrics/<name>.py`` from a profiled stretch of the window.

The run exits non-zero and prints no result without a CUDA device (or
with fewer than the cell asks for), and when JAX or the JAX package
``kbslam`` is loaded once the window has closed.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from slambench.harness import manifest, report  # noqa: E402
from slambench.harness.context import Context, Result  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def read_layer_metrics(cell, layer: dict) -> dict:
    """The per-layer metrics the cell reports, each from its reader; a
    reader that finds nothing returns None and its metric is left out."""
    out = {}
    for m in cell.per_layer:
        v = manifest.load_module("metrics", m["name"]).read(layer)
        if v is not None:
            out[m["name"]] = v
    return out


def execute(ctx: Context, driver) -> tuple:
    """(result, metrics for the line, units, correct, check)."""
    res: Result = driver.run(ctx)
    limits = ctx.cell.traffic["check"]["limits"]
    from slambench.harness.compare import judge

    correct, check = judge(res.numbers, limits)
    if ctx.trace:
        metrics = read_layer_metrics(ctx.cell, res.layer)
        units = {m["name"]: m["unit"] for m in ctx.cell.per_layer}
    else:
        metrics = {m["name"]: res.metrics[m["name"]]
                   for m in ctx.cell.end_to_end}
        units = {m["name"]: m["unit"] for m in ctx.cell.end_to_end}
    return res, metrics, units, correct, check


def main(argv=None) -> int:
    args = parse(argv)
    try:
        cell = manifest.load_cell(args.workload)
    except (KeyError, FileNotFoundError) as e:
        print(f"slambench: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"slambench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = manifest.load_module("drivers", cell.traffic["driver"])
    ctx = Context(cell, args.seed, args.seconds, bool(args.trace),
                  torch.device("cuda", 0))
    res, metrics, units, correct, check = execute(ctx, driver)
    bad = report.forbidden_modules()
    if bad:
        print(f"slambench: loaded after the window: {bad}", file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": res.memory_peak_bytes}
    breakdown = None
    if ctx.trace:
        device["busy_s"] = res.layer["busy_s"]
        device["window_s"] = res.layer["window_s"]
        breakdown = res.layer["breakdown"]
    for line in res.info:
        print(line, file=sys.stderr)
    for line in report.check_lines(check):
        print(line, file=sys.stderr)
    print(report.result_line(correct, res.attempted, res.failed, metrics,
                             units, device, check, breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
