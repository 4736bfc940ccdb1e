"""Phase timers and named ranges for device timelines.

Port of ``mdgat_tpu/utils/profiling.py``: wall-clock phase timers with mean /
percentile reporting, and :func:`trace_annotation`, which on a CUDA build is an
NVTX range (shown by ``torch.profiler`` and Nsight timelines) where the JAX
package uses ``jax.profiler.TraceAnnotation``.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List

import torch


@contextlib.contextmanager
def trace_annotation(name: str):
    """Named region in the device trace; nothing without a CUDA device."""
    if not torch.cuda.is_available():
        yield
        return
    with torch.cuda.nvtx.range(name):
        yield


class PhaseTimer:
    """Wall-clock phase accumulator: ``with timer('data'): ...``. CUDA
    launches are asynchronous: a phase that only enqueues work measures the
    enqueue unless the caller synchronises inside it."""

    def __init__(self):
        self.times: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, phase: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[phase].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for k, v in self.times.items():
            arr = sorted(v)
            out[k] = {
                "count": len(v),
                "total": sum(v),
                "mean": sum(v) / len(v),
                "p50": arr[len(arr) // 2],
                "max": arr[-1],
            }
        return out

    def report(self) -> str:
        lines = []
        for k, s in sorted(self.summary().items()):
            lines.append(f"{k:>16}: n={s['count']:<5} total={s['total']:.2f}s "
                         f"mean={s['mean'] * 1e3:.2f}ms max={s['max'] * 1e3:.2f}ms")
        return "\n".join(lines)
