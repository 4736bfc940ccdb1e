"""Launch and collective counters that several threads tick at once.

The kernel wrappers count their launches in integer attributes
(``gemm.launches``, ...) and ``parallel/mesh.py`` its collectives in a
``Counter``; the one-process multi-device runtime
(``parallel/smap.py::make_eval_runtime``) runs a forward on each of several
threads. A read-modify-write of an attribute or of a ``Counter`` entry is
not atomic under the interpreter lock, so every increment takes one lock.
A ``utils/graphs.py::Captured`` counts its warm-ups, captures and replays
the same way, and the graph runtime's account (``graphs.TOTALS``) its
seconds and pool bytes. A wrapper's count ticks where its Python runs: at
an eager call and at a capture, never at a graph's replay. So the launch counters are route checks, which the tests
and ``chip_smoke.py`` read to see which kernels a program holds; they are
not a measure of a window's work (the benchmark reads that from the
device trace).
"""

from __future__ import annotations

import threading

# reentrant: a collected Captured's finalizer (utils/graphs.py) may run, and
# tick, inside a tick of the same thread
_LOCK = threading.RLock()


def tick(obj, attr: str = "launches", n=1, peak: str = None):
    """Add ``n`` to the attribute ``attr`` of ``obj``; with ``peak``, raise
    the attribute ``peak`` to the new value where that is more."""
    with _LOCK:
        value = getattr(obj, attr) + n
        setattr(obj, attr, value)
        if peak is not None and value > getattr(obj, peak):
            setattr(obj, peak, value)


def tick_kind(counter, kind: str, n: int = 1):
    """Add ``n`` to ``counter[kind]`` (a ``collections.Counter``)."""
    with _LOCK:
        counter[kind] += n
