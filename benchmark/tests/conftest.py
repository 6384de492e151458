"""CPU tests of the benchmark.  Tests that need a CUDA device carry the
``cuda`` marker and decide inside the test whether there is one.

    python -m pytest benchmark/tests -q
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")
