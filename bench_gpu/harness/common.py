"""What every cell shares: the benchmark's files, host spans, the result
line, and the guard against JAX in the process.

The harness is driven by files, found by name: ``BENCHMARK.json`` at the
checkout's root, ``configs/<config>.json``, ``workloads/<cell>.json``,
``metrics/<name>.py`` and ``architectures/<architecture>.py`` under a
folder that is this package unless a caller (a test) gives another. A
per-layer metric's file holds one function, ``read(readings) -> float |
None``; None leaves the metric out of the result line. An architecture's
file holds the contract of ``architectures/__init__.py``; a configuration
names it with ``"architecture"``, and without that key it is
``"mdgat"``.
"""

from __future__ import annotations

import contextlib
import ctypes
import ctypes.util
import importlib.util
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent
# top-level module names that no process of the benchmark may hold: JAX,
# the JAX package, and the JAX package's bench and smoke scripts
FORBIDDEN = ("jax", "jaxlib", "flax", "mdgat_tpu", "bench", "chip_smoke")


# glibc's mallopt parameters
M_TRIM_THRESHOLD = -1
M_MMAP_THRESHOLD = -3


def fix_malloc() -> bool:
    """Fix glibc malloc's thresholds for this process: blocks up to 256 MiB
    come from the heap, and freed memory goes back to the system only past
    1 GiB at the heap's top. With glibc's dynamic thresholds a fresh
    process maps new pages for a serving call's host arrays and hands them
    back after it, call after call, until its thresholds have climbed: on
    an H100 host fpfh-match ran 1600-2100 pairs/s in a fresh process and
    2400-2700 in one that had served before. Called first thing, before
    numpy and torch allocate. False where the C library has no
    ``mallopt`` or refuses a value."""
    try:
        mallopt = ctypes.CDLL(ctypes.util.find_library("c")
                              or "libc.so.6").mallopt
    except (OSError, AttributeError):
        return False
    mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
    return bool(mallopt(M_TRIM_THRESHOLD, 1 << 30)
                and mallopt(M_MMAP_THRESHOLD, 1 << 28))


DEFAULT_ARCHITECTURE = "mdgat"


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _found(path: Path) -> Path:
    if not path.is_file():
        raise FileNotFoundError(f"no such benchmark file: {path}")
    return path


def _load_module(path: Path, prefix: str, name: str):
    spec = importlib.util.spec_from_file_location(
        prefix + name.replace(".", "_").replace("-", "_"), _found(path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark(root: Path = ROOT) -> Dict:
    return load_json(_found(root / "BENCHMARK.json"))


def workload(name: str, folder: Path = PKG) -> Dict:
    return load_json(_found(folder / "workloads" / f"{name}.json"))


def config(name: str, folder: Path = PKG) -> Dict:
    return load_json(_found(folder / "configs" / f"{name}.json"))


def metric_reader(name: str, folder: Path = PKG):
    """The ``read`` function of ``metrics/<name>.py``."""
    return _load_module(folder / "metrics" / f"{name}.py",
                        "bench_gpu_metric_", name).read


def architecture(config: Dict, folder: Path = PKG):
    """The module ``architectures/<architecture>.py`` that the configuration
    file's contents ``config`` name."""
    name = config.get("architecture", DEFAULT_ARCHITECTURE)
    return _load_module(folder / "architectures" / f"{name}.py",
                        "bench_gpu_architecture_", name)


def per_layer_for(cell: str, bench: Dict) -> List[Dict]:
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell])]


def end_to_end_for(cell: str, bench: Dict) -> List[Dict]:
    return [m for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])]


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is forbidden,
    compared whole (``mdgat_tpu_torch`` is not ``mdgat_tpu``)."""
    return sorted(name for name in list(sys.modules)
                  if name.split(".")[0] in FORBIDDEN)


class Spans:
    """Host spans the harness puts around its own calls: seconds by name,
    and with ``traced`` a ``record_function`` named ``bench.<name>`` that
    the device trace holds on the same clock."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.seconds: Dict[str, List[float]] = defaultdict(list)

    def reset(self):
        self.seconds.clear()

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        if self.traced:
            from torch.profiler import record_function
            with record_function("bench." + name):
                yield
        else:
            yield
        self.seconds[name].append(time.perf_counter() - t)

    def wrap(self, name: str, fn):
        def wrapped(*args, **kwargs):
            with self(name):
                return fn(*args, **kwargs)
        return wrapped


class Readings:
    """What a per-layer metric's reader reads: the device trace of the
    traced window (None when there is none), the host spans of the window
    (seconds by name), the work of the iterations in it
    (``work.per_iteration``'s counts), and cell-specific readings taken
    outside the window (``extra``)."""

    def __init__(self, trace=None, spans=None, work=None, extra=None):
        self.trace = trace
        self.spans = spans or {}
        self.work = work
        self.extra = extra or {}


def card_line() -> str:
    """``name, power limit`` of the card, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def emit(result: Dict, checks: Dict[str, Dict[str, float]]):
    """Each compared number beside its limit as the last lines of standard
    error, then the result line (``checks`` its last key) as the last line
    of standard output."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    line = dict(result)
    line["checks"] = checks
    print(json.dumps(line), flush=True)
