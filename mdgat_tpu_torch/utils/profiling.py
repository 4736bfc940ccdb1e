"""Program spans on the profiler's clock, and the train loop's phase timer.

:func:`span` names a stretch of the program's host work in a
``torch.profiler`` trace: while a profiling session records on the calling
thread it is a ``user_annotation`` event in the same Chrome trace as the
card's kernels, copies and sets (CUPTI), on the same clock. That trace is
the one the entry points' ``--trace_dir`` writes. While no session records
it is one shared no-op context, after a single check of the profiler's
state.

Spans sit at the host-side layer boundaries and nowhere else; a span's
name is ``mdgat.<layer>.<what>``:

* entry: ``mdgat.entry.match_batch`` (``api.py::Matcher.match_batch``),
  ``mdgat.entry.train_step`` (``train/loop.py::make_train_step``),
  ``mdgat.entry.eval_step`` (``make_eval_step``), ``mdgat.entry.eval_batch``
  (one ``eval/runner.py::EvalPipeline`` iteration);
* data path: ``mdgat.data.host_batch`` (``Matcher._host_batch``: padding,
  normalisation, stacking), ``mdgat.data.upload`` (``parallel/smap.py::
  _on``, the Matcher's host-to-device copies), ``mdgat.data.readback`` (the
  ``.cpu()`` reads of ``match_batch`` and of ``EvalPipeline``),
  ``mdgat.data.unpack`` (``match_batch``'s per-pair dicts),
  ``mdgat.data.prepare`` (``data/pipeline.py::prepare_batch``) and in it
  ``mdgat.data.pin`` (pinned staging and the enqueued copies) and
  ``mdgat.data.ground_truth``, ``mdgat.data.wait`` (a consumer waiting on
  a producer thread's queue: ``data/prefetch.py``, ``EvalPipeline``);
* graph runtime (``utils/graphs.py::Captured``): ``mdgat.graphs.warm_up``,
  ``mdgat.graphs.capture``, ``mdgat.graphs.replay`` (the static copy, the
  replay's launch, the output clones).

The entry spans carry the call's identifier (the Matcher's call number,
the train state's step, the eval pipeline's batch index) in the event's
``Concrete Inputs`` where the session records shapes; the spans inside a
call are grouped with it by their time. No span sits inside the model's
forward: under a replayed graph its Python does not run.
``torch.profiler`` records a span on the thread that started the session;
on a producer thread or a ``Matcher`` grid's cell it records nothing.
``tools/trace_idle.py`` reads such a trace back: the card's idle time by
the innermost span open on the host.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List

import torch

_OFF = contextlib.nullcontext()
_recording = torch.autograd._profiler_enabled    # per thread


class _Span:
    """A recording span: ``torch.autograd``'s record function with
    arguments, a ``user_annotation`` in the trace."""

    __slots__ = ("name", "args", "handle")

    def __init__(self, name: str, args: tuple):
        self.name, self.args = name, args

    def __enter__(self):
        self.handle = torch.autograd._record_function_with_args_enter(
            self.name, *self.args)
        return self

    def __exit__(self, *exc):
        torch.autograd._record_function_with_args_exit(self.handle)
        return False


def span(name: str, args=None):
    """A context naming ``name`` (``mdgat.<layer>.<what>``) in the
    profiler's trace while a session records on this thread, else a shared
    no-op context. ``args``, an entry span's identifier (an int), goes into
    the event's ``Concrete Inputs`` where the session records shapes."""
    if not _recording():
        return _OFF
    return _Span(name, () if args is None else (args,))


class PhaseTimer:
    """Wall-clock phase accumulator: ``with timer('data'): ...``, the
    printed phase report of ``train_torch.py``. CUDA launches are
    asynchronous: a phase that only enqueues work measures the enqueue
    unless the caller synchronises inside it. It opens no span of its own:
    the spans inside the calls it times (:func:`span`) show in a
    ``--trace_dir`` trace."""

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
