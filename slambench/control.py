"""Readings for the correctness limits of one cell, on the card.

    python3 slambench/control.py --workload <cell> --seeds 1,2,3 --seconds <s>
        [--plant <name>] [--no-control] [--traffic key=json ...]

For each seed, one run of the cell (as ``run.py`` makes it, untraced)
whose check also runs the control (``harness/control.py``: the reference
with every float32 matrix product in TF32) from the same states and
holds it to the float32 reference. Prints, per seed, one JSON line with
the program's numbers (the lower readings) and the control's (the upper
readings). The benchmark's own runs never run the control.

``--plant`` plants a change of ``harness/plants.py`` in the program
first (a fault the check has to catch: the program's numbers are then
the fault's readings); ``--no-control`` leaves the control out;
``--traffic`` replaces keys of the cell's traffic mix (such as
``ba_mode="async"``).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from slambench.harness import manifest, plants  # noqa: E402
from slambench.harness.context import Context  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--plant", choices=sorted(plants.PLANTS))
    p.add_argument("--no-control", action="store_true")
    p.add_argument("--traffic", action="append", default=[])
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.plant:
        plants.PLANTS[args.plant](setattr)
    cell = manifest.load_cell(args.workload)
    traffic = dict(cell.traffic)
    for kv in args.traffic:
        key, value = kv.split("=", 1)
        traffic[key] = json.loads(value)
    cell = cell._replace(traffic=traffic)
    driver = manifest.load_module("drivers", cell.traffic["driver"])
    for seed in (int(s) for s in args.seeds.split(",")):
        res = driver.run(Context(cell, seed, args.seconds, False,
                                 torch.device("cuda", 0),
                                 control=not args.no_control))
        for line in res.info:
            print(line, file=sys.stderr)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "plant": args.plant, "failed": res.failed,
                          "program": res.numbers,
                          "control": res.control_numbers,
                          "metrics": res.metrics}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
