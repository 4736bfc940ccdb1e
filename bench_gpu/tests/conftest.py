"""CPU tests of the benchmark's harness: ``python -m pytest bench_gpu/tests``.

Tests marked ``card`` need a CUDA device and skip without one; they decide
inside the test, never while a module is imported. Nothing here imports
JAX, the JAX package, ``bench.py`` or ``chip_smoke.py``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")
