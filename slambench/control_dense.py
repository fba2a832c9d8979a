"""``control.py`` with the dense model's faults besides its own: readings
for the correctness limits of ``desk-dense512-replay`` on the card.

    python3 slambench/control_dense.py --workload desk-dense512-replay \\
        --seeds 1,2,3 --seconds <s> [--plant fuse-wrong-slot|icp-dropped]
        [--no-control]

The plants of ``harness/plants_dense.py`` join ``harness/plants.py``'s
table in this process only; everything else is ``control.py``'s.
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from slambench import control  # noqa: E402
from slambench.harness import plants, plants_dense  # noqa: E402


def main(argv=None) -> int:
    plants.PLANTS.update(plants_dense.PLANTS)
    return control.main(argv)


if __name__ == "__main__":
    sys.exit(main())
