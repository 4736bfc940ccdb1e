#!/usr/bin/env python3
"""The card's idle time in a ``torch.profiler`` Chrome trace (the entry
points' ``--trace_dir`` writes one a rank) by the innermost program span
(``mdgat_tpu_torch/utils/profiling.py::span``) open on the host, as JSON.

    python3 tools/trace_idle.py DIR/trace_rank0.json [--window SPAN]

Exits 1 where the trace holds no kernel, copy or set (a CPU run's trace).
"""

import argparse
import bisect
import json
import sys
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Sequence

# what the card runs, by the trace's event categories
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(intervals):
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(spans):
    """The timeline cut where a span opens or closes: (start, end, name of
    the innermost span open) for every stretch under at least one span."""
    points = sorted([(s, 1, -e, i) for i, (_, s, e) in enumerate(spans)]
                    + [(e, 0, 0, i) for i, (_, s, e) in enumerate(spans)])
    out, open_, prev = [], [], None
    for t, opens, _, i in points:
        if open_ and t > prev:
            out.append((prev, t, spans[open_[-1]][0]))
        if opens:
            open_.append(i)
        else:
            open_.remove(i)
        prev = t
    return out


def idle_by_span(events: Sequence[Dict], window: Optional[str] = None,
                 prefixes=("mdgat.",)) -> Optional[Dict]:
    """The card's idle time in a Chrome trace (``torch.profiler``'s export:
    ``ts`` / ``dur`` in microseconds) by the innermost span open on the
    host, of the ``user_annotation`` spans whose names start with one of
    ``prefixes``. The window is the first span named ``window`` and the
    spans are those of its thread; without one it runs from the first to
    the last device operation, over the thread that holds the most spans
    (a profiler records spans on the thread that started it).
    Busy is the union of the kernels, copies and sets in the window.

    Returns None without a device operation, else ``window_s``,
    ``busy_s``, ``idle_s``; ``idle_s_by_span`` (the name of the innermost
    span, ``""`` where none is open); ``gaps``, the ten longest idle
    stretches, each ``[innermost span at its midpoint, seconds]``; and
    ``calls``, the outermost ``mdgat.entry.*`` spans in the window."""
    spans, device, win = [], [], None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = float(e["ts"]) * 1e-6
        t = s + float(e["dur"]) * 1e-6
        name = e.get("name", "")
        if e.get("cat") in DEVICE_CATS:
            device.append((s, t))
        elif e.get("cat") == "user_annotation":
            if window is not None and name == window:
                win = win or (s, t, e.get("tid"))
            elif name.startswith(tuple(prefixes)):
                spans.append((name, s, t, e.get("tid")))
    if not device:
        return None
    if win is None:
        tids = Counter(tid for *_, tid in spans).most_common(1)
        win = (min(s for s, _ in device), max(t for _, t in device),
               tids[0][0] if tids else None)
    w0, w1, tid = win
    spans = sorted((n, max(s, w0), min(t, w1)) for n, s, t, th in spans
                   if th == tid and t > w0 and s < w1)
    busy = _union([(max(s, w0), min(t, w1)) for s, t in device
                   if t > w0 and s < w1])
    gaps, prev = [], w0
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if w1 > prev:
        gaps.append((prev, w1))
    segs = _innermost(spans)
    starts = [a for a, _, _ in segs]

    def label(t):
        i = bisect.bisect_right(starts, t) - 1
        return segs[i][2] if i >= 0 and t <= segs[i][1] else ""

    by: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        covered = 0.0
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(segs) and segs[i][0] < b:
            lo, hi = max(a, segs[i][0]), min(b, segs[i][1])
            if hi > lo:
                by[segs[i][2]] += hi - lo
                covered += hi - lo
            i += 1
        if b - a > covered:
            by[""] += b - a - covered
    calls, end = 0, float("-inf")
    for n, s, t in sorted(spans, key=lambda x: (x[1], -x[2])):
        if n.startswith("mdgat.entry.") and t > end:
            calls, end = calls + 1, t
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    busy_s = sum(t - s for s, t in busy)
    return {"window_s": w1 - w0, "busy_s": busy_s,
            "idle_s": w1 - w0 - busy_s, "idle_s_by_span": dict(by),
            "gaps": [[label(0.5 * (a + b)), b - a] for a, b in longest],
            "calls": calls}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("trace")
    p.add_argument("--window", default=None,
                   help="the name of a span bounding the window (default: "
                   "from the first to the last device operation)")
    args = p.parse_args(argv)
    with open(args.trace) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    got = idle_by_span(events, args.window)
    if got is None:
        print(f"{args.trace}: no device operation", file=sys.stderr)
        return 1
    print(json.dumps(got, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
