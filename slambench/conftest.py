"""pytest settings of the benchmark's own tests: the repository root on
the path, and the ``cuda`` marker for tests that need the card."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the benchmark measures the "
        "card); skips without one")
