"""Launch and collective counters that several threads tick at once.

The kernel wrappers count their launches in integer attributes
(``gemm.launches``, ...) and ``parallel/mesh.py`` its collectives in a
``Counter``; the one-process multi-device runtime
(``parallel/smap.py::make_eval_runtime``) runs a forward on each of several
threads. A read-modify-write of an attribute or of a ``Counter`` entry is
not atomic under the interpreter lock, so every increment takes one lock.
"""

from __future__ import annotations

import threading

_LOCK = threading.Lock()


def tick(obj, attr: str = "launches", n: int = 1):
    """Add ``n`` to the integer attribute ``attr`` of ``obj``."""
    with _LOCK:
        setattr(obj, attr, getattr(obj, attr) + n)


def tick_kind(counter, kind: str, n: int = 1):
    """Add ``n`` to ``counter[kind]`` (a ``collections.Counter``)."""
    with _LOCK:
        counter[kind] += n
