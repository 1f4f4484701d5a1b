"""Settings of the benchmark's own tests: the ``card`` marker, and the repository
root on the import path."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
if str(Path(__file__).resolve().parent) not in sys.path:
    sys.path.insert(0, str(Path(__file__).resolve().parent))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one (run on the card: python3 -m pytest cardbench/tests -m card)")
