"""Arithmetic the per-layer metrics' readers share (``metrics/*.py``).
Each returns None where the run holds nothing to read, never 0 for a
share of a peak or a roofline."""

from __future__ import annotations

import re
from typing import Optional

from bench_gpu.harness.work import PEAK_F32_FLOPS


def _on_card(r) -> bool:
    """The run holds a device trace: a window in which the card ran
    something (a trace of the host alone has no device operation)."""
    return r.trace is not None and bool(r.trace.ops) and r.trace.window_s > 0


def idle_pct(r) -> Optional[float]:
    """The traced window's share in which no device operation ran."""
    if not _on_card(r):
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)


def mfu_pct(r) -> Optional[float]:
    """The model operations of the window's iterations over what the card
    could do in the window at its float32 peak."""
    if not _on_card(r) or not r.work:
        return None
    return 100.0 * r.work["flops"] / (r.trace.window_s * PEAK_F32_FLOPS)


def roofline_pct(r, kernels: str, bound_key: str) -> Optional[float]:
    """The least time the window's work of one kind needs over the device
    time of the kernels (``kernels``, a regular expression on their names)
    that do it."""
    if not _on_card(r) or not r.work or not r.work.get(bound_key):
        return None
    seconds = r.trace.seconds(kernels)
    if seconds <= 0:
        return None
    return 100.0 * r.work[bound_key] / seconds


def span_ms(r, name: str) -> Optional[float]:
    """Mean host ms of the harness span ``name`` in the window."""
    times = r.spans.get(name)
    if not times:
        return None
    return 1e3 * sum(times) / len(times)


def program_span_ms(r, name: str) -> Optional[float]:
    """Mean host ms of the program's span ``name`` (its whole name,
    ``mdgat.data.host_batch``) in the traced window."""
    if r.trace is None:
        return None
    spans = r.trace.program_spans(name)
    if not spans:
        return None
    return 1e3 * sum(e - s for s, e, _ in spans) / len(spans)


def kernel_pattern(*names: str) -> str:
    """A regular expression matching any of the kernels ``names`` as whole
    identifiers (``gemm_kernel`` and not ``gemm_tn_kernel``)."""
    return r"(?<![A-Za-z0-9_])(" + "|".join(map(re.escape, names)) + r")\b"
