"""The device trace of a traced window, and what is read from it.

``torch.profiler`` (CUPTI) records every kernel, copy and set the card
runs, kernels replayed from a CUDA graph included, and the harness's host
spans (``record_function``) on the same clock. The trace is exported as
Chrome JSON into the run's temporary directory, read back and deleted.

Busy time is the union of the device intervals inside the window, so that
a copy on another stream under a kernel is counted once (a sum of each
operation's device time counts overlaps twice). An idle gap is a stretch of
the window in which no device interval runs; it is labelled with the
innermost harness span open on the host at its midpoint.

The program's own spans (``mdgat.*``, ``utils/profiling.py::span``) in the
window are kept too, with their thread, for the metric files that read
them (``Trace.program_spans``); the labels, the top operations and the
idle gaps read only the harness's spans. Without the card (the CPU tests)
the profiler records the host alone: the trace holds the spans and no
device operation, and the device's readers read nothing from it.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

WINDOW_SPAN = "bench.window"
PROGRAM_PREFIX = "mdgat."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    window_s: float
    busy_s: float
    ops: List[Tuple[str, float, float]]       # (name, start s, end s)
    spans: List[Tuple[str, float, float]]     # host spans in the window
    gaps: List[Tuple[float, float]] = field(default_factory=list)
    # the program's spans in the window: (name, start s, end s, thread)
    program: List[Tuple[str, float, float, int]] = field(
        default_factory=list)

    def program_spans(self, name: str) -> List[Tuple[float, float, int]]:
        """(start s, end s, thread) of each program span ``name`` (the
        whole name, ``mdgat.data.host_batch``) in the window."""
        return [(s, e, tid) for n, s, e, tid in self.program if n == name]

    def seconds(self, pattern: str) -> float:
        """Device seconds of the operations whose name matches
        ``pattern`` (a regular expression), inside the window."""
        rx = re.compile(pattern)
        return sum(e - s for name, s, e in self.ops if rx.search(name))

    def top_ops(self, count: int = 10) -> List[List]:
        """The ``count`` operations that took the most device seconds,
        by name without template arguments."""
        by: Dict[str, float] = {}
        for name, s, e in self.ops:
            key = _short(name)
            by[key] = by.get(key, 0.0) + (e - s)
        return [[name, secs] for name, secs in
                sorted(by.items(), key=lambda kv: -kv[1])[:count]]

    def idle_gaps(self, count: int = 10) -> List[List]:
        gaps = sorted(self.gaps, key=lambda g: -(g[1] - g[0]))[:count]
        return [[self.label(0.5 * (a + b)), b - a] for a, b in gaps]

    def label(self, t: float) -> str:
        inner = None
        for name, s, e in self.spans:
            if s <= t <= e and (inner is None or e - s < inner[2] - inner[1]):
                inner = (name, s, e)
        return inner[0] if inner else "no harness span"


def _short(name: str) -> str:
    """A kernel's name without its template arguments and parameters."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::",
                                                   "")
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:120] or name[:120]


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def read_events(events: List[Dict]) -> Optional[Trace]:
    """A :class:`Trace` from Chrome trace events (``ts`` / ``dur`` in
    microseconds); None without the window span."""
    window = [e for e in events if e.get("name") == WINDOW_SPAN
              and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not window:
        return None
    w0 = float(window[0]["ts"]) * 1e-6
    w1 = w0 + float(window[0]["dur"]) * 1e-6
    ops, spans, program = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = float(e["ts"]) * 1e-6
        t = s + float(e["dur"]) * 1e-6
        if e.get("cat") in DEVICE_CATS:
            s, t = max(s, w0), min(t, w1)
            if t > s:
                ops.append((e.get("name", "?"), s, t))
        elif e.get("cat") == "user_annotation" and t > w0 and s < w1:
            name = e.get("name", "")
            if name.startswith("bench.") and name != WINDOW_SPAN:
                spans.append((name, s, t))
            elif name.startswith(PROGRAM_PREFIX):
                program.append((name, s, t, e.get("tid")))
    busy = union([(s, t) for _, s, t in ops])
    gaps, prev = [], w0
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if w1 > prev:
        gaps.append((prev, w1))
    return Trace(window_s=w1 - w0, busy_s=sum(t - s for s, t in busy),
                 ops=ops, spans=spans, gaps=gaps, program=program)


class Profiled:
    """``with Profiled(on, device) as p:`` around a window; ``p.window()``
    wraps the loop inside it, ``p.trace`` holds the :class:`Trace`
    afterwards (None when off). Off the card it records the host alone."""

    def __init__(self, on: bool, device):
        self.on = on
        self.cuda = device.type == "cuda"
        self.trace: Optional[Trace] = None
        self._prof = None

    def _sync(self):
        if self.cuda:
            import torch
            torch.cuda.synchronize()

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile
            self._sync()
            self._prof = profile(activities=[ProfilerActivity.CPU]
                                 + ([ProfilerActivity.CUDA] if self.cuda
                                    else []))
            self._prof.__enter__()
        return self

    def window(self):
        if not self.on:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(WINDOW_SPAN)

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        self._sync()
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.unlink(path)
        events = data["traceEvents"] if isinstance(data, dict) else data
        self.trace = read_events(events)
        return False
