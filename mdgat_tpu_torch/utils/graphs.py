"""CUDA-graph capture of a step, once per shape bucket: the port's ``jit``.

Counterpart of the JAX package's compiled programs: the jitted train and
eval steps (``mdgat_tpu/train/loop.py:60``, ``:70``), the mesh runtimes
jitted once per batch signature and cached
(``mdgat_tpu/parallel/smap.py:120-167``) and the ``Matcher``'s one jitted
forward per shape bucket (``mdgat_tpu/api.py:10``). Eagerly, PyTorch
enqueues a default train step as about 1700 launches from Python and an
eval forward as about 440; a replayed graph is one launch.

:class:`Captured` wraps a step ``fn(batch) -> outputs`` (``batch`` a dict of
tensors, ``outputs`` a dict, tuple or list of tensors) and keeps a small
cache keyed on each input tensor's name, shape, dtype and device, plus the
Python-side choices a capture bakes in, which the caller passes as
``key=`` (train or eval mode, the Sinkhorn plan's pair count, the top-k
arm):

* the first call of a key runs ``fn`` eagerly (the warm-up), on a side
  stream kept for that key, so that the kernel library's ``nvcc`` build,
  the kernels' attribute calls, cuBLAS's workspace for that stream and the
  allocator's blocks all fall outside any capture;
* the second captures ``fn`` on that stream into a ``torch.cuda.CUDAGraph``
  (``capture_error_mode="thread_local"``: the cells of a ``Matcher`` grid
  capture on threads of their own, one capture at a time in the process),
  and replays it;
* every later call replays: the inputs are copied into the graph's static
  buffers, the graph runs on the caller's current stream, and the outputs
  come back as clones, so that no caller holds memory the next replay
  overwrites.

At most ``max_graphs`` keys are kept, the least recently used dropped first;
each graph owns a private memory pool. The kernel wrappers' launch counters
tick where their Python runs, at the warm-up and at the capture, never at a
replay. A :class:`Captured` counts its own ``warm_ups``, ``captures`` and
``replays`` under the counters' lock (``utils/counting.py``). The process's
graph runtime keeps one account, :data:`TOTALS`, which the benchmark's
``graph_setup_s`` and ``graph_pool_gib`` read: the host seconds of the warm-ups and captures (``warm_up_s``, ``capture_s``; less
the kernel library's build, which ``ops/cuda/_build.py`` times), and
``pool_bytes``, for each live graph the caching allocator's reserve after
its capture less before it (its private pool; 0 on a backend that
captures nothing), taken off when the graph is dropped, with the most the
live pools held at once (``pool_bytes_peak``). A replay counts only its
``replays``. The warm-up, the capture and the replay each open a span
(``utils/profiling.py``).

Nothing falls back: a capture or a replay that fails raises, and nothing
re-runs the call eagerly. Where a step cannot be captured it is eager by
design (:func:`use_graphs`); the data- and seq-parallel steps, whose
collectives sit between the layers, are eager in their callers.

The backend (:data:`BACKEND`) does the device work: :class:`CudaGraphs` on
the card. The tests put a CPU stand-in in its place, which re-runs ``fn``
on the static buffers at every replay.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
import weakref
from typing import Callable, Dict, Optional

import torch

from mdgat_tpu_torch.ops.cuda import _build
from mdgat_tpu_torch.utils.counting import tick
from mdgat_tpu_torch.utils.profiling import span

MAX_GRAPHS = 8
# clouds above this many keypoints take MDGAT's kernels' wide arms, which
# size a scratch tensor from the card's free memory at every call: eager
WIDE_KEYPOINTS = 1024

_DISABLED = 0                    # depth of open disabled() blocks
_DISABLED_LOCK = threading.Lock()
_CAPTURE_LOCK = threading.Lock()  # one capture at a time in the process


@contextlib.contextmanager
def disabled():
    """Inside the block :func:`use_graphs` is false on every thread, so
    every step and forward runs eagerly: the counterpart of
    ``jax.disable_jit``, for code that has no ``Config`` to set
    ``cuda_graphs=False`` on (the entry points, which keep the JAX
    package's flags)."""
    global _DISABLED
    with _DISABLED_LOCK:
        _DISABLED += 1
    try:
        yield
    finally:
        with _DISABLED_LOCK:
            _DISABLED -= 1


def use_graphs(cfg, device, batch: Optional[Dict] = None,
               any_size: bool = False) -> bool:
    """Whether a train or eval step of a model of ``cfg`` on ``device``
    runs through :class:`Captured`: ``cfg.cuda_graphs``, a kernel route
    (``cfg.use_kernels``; the plain route is what the kernels are held
    against, and its fast-top-k twin reads a value back), a device the
    backend captures on (CUDA), no :func:`disabled` block, no autograd
    anomaly mode (``--debug_nans``, whose checks read values back), and,
    when ``batch`` is given, clouds of at most ``WIDE_KEYPOINTS``
    keypoints unless ``any_size``: the model's ``captures_any_size``, true
    of a net whose kernels size their scratch from the shapes alone
    (LightGlue)."""
    if not (cfg.cuda_graphs and cfg.use_kernels and not _DISABLED
            and not torch.is_anomaly_enabled()
            and BACKEND.supports(torch.device(device))):
        return False
    if batch is None or any_size:
        return True
    return all(batch[k].shape[1] <= WIDE_KEYPOINTS
               for k in ("keypoints0", "keypoints1") if k in batch)


def _map(fn, tree):
    """``fn`` over the tensors of a dict / tuple / list of tensors."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


class CudaGraphs:
    """The backend on the card: a side stream a key, ``torch.cuda.
    CUDAGraph`` captures on it, replays on the caller's stream ordered
    after the previous replay of the same graph."""

    @staticmethod
    def supports(device: torch.device) -> bool:
        return device.type == "cuda"

    @staticmethod
    def context(device: torch.device):
        return {"stream": torch.cuda.Stream(device), "done": None}

    @staticmethod
    def warm_up(fn, batch, ctx):
        stream = ctx["stream"]
        current = torch.cuda.current_stream(stream.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            out = fn(batch)
        current.wait_stream(stream)
        return out

    @staticmethod
    def capture(fn, static, ctx) -> Callable:
        stream = ctx["stream"]
        graph = torch.cuda.CUDAGraph()
        stream.wait_stream(torch.cuda.current_stream(stream.device))
        with _CAPTURE_LOCK, torch.cuda.stream(stream):
            reserved = torch.cuda.memory_reserved(stream.device)
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = fn(static)
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass        # the capture was already invalidated
                raise
            graph.capture_end()
            # the graph's private pool: what the capture added to the reserve
            ctx["pool_bytes"] = (torch.cuda.memory_reserved(stream.device)
                                 - reserved)

        def replay():
            graph.replay()
            return out
        return replay

    @staticmethod
    def before_replay(ctx, device):
        if ctx["done"] is not None:
            torch.cuda.current_stream(device).wait_event(ctx["done"])

    @staticmethod
    def after_replay(ctx, device):
        if ctx["done"] is None:
            ctx["done"] = torch.cuda.Event()
        ctx["done"].record(torch.cuda.current_stream(device))

    @staticmethod
    def release(ctx):
        # the graph and its pool go only after its last replay has run
        if ctx["done"] is not None:
            ctx["done"].synchronize()


BACKEND = CudaGraphs()


class Totals:
    """The graph runtime's account of the process (module docstring): one
    a process, as the caching allocator keeps one, so a reader needs no
    handle on the caches, which the steps and ``Matcher`` hold inside
    them."""

    def __init__(self):
        self.warm_up_s = self.capture_s = 0.0
        self.pool_bytes = self.pool_bytes_peak = 0


TOTALS = Totals()


def _host_seconds(t0: float) -> float:
    """Seconds since ``t0`` (``time.perf_counter``) less those in which the
    kernel library was being built: a first use's build, or the wait on
    another thread's."""
    t1 = time.perf_counter()
    lib = _build._LIBRARY
    if lib is None or lib.built is None:
        return t1 - t0
    b0, b1 = lib.built
    return t1 - t0 - max(0.0, min(t1, b1) - max(t0, b0))


def _add_pool(n: int):
    tick(TOTALS, "pool_bytes", n, peak="pool_bytes_peak")


def _forget_pools(entries):
    """A dropped :class:`Captured`'s live pools leave :data:`TOTALS`."""
    _add_pool(-sum(e.pool_bytes for e in entries.values()))


class _Entry:
    __slots__ = ("ctx", "static", "replay", "pool_bytes")

    def __init__(self, ctx):
        self.ctx = ctx
        self.static = None      # the graph's input buffers, after capture
        self.replay = None      # launches the graph, returns its outputs
        self.pool_bytes = 0     # its private pool, after capture


class Captured:
    """``fn`` warmed up, captured and replayed per key (module docstring).
    Call as ``captured(batch, key=...)``; ``batch`` is a dict of tensors
    on one device, ``key`` a hashable of the choices baked into a capture.
    One call at a time: concurrent callers of one instance take turns."""

    def __init__(self, fn: Callable, max_graphs: int = MAX_GRAPHS):
        if max_graphs < 1:
            raise ValueError(f"max_graphs {max_graphs}: at least 1")
        self.fn = fn
        self.max_graphs = max_graphs
        self._entries: "collections.OrderedDict" = collections.OrderedDict()
        self._lock = threading.Lock()
        self.warm_ups = self.captures = self.replays = 0
        weakref.finalize(self, _forget_pools, self._entries).atexit = False

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self):
        """Drop every graph (after the step's state was replaced: a
        loaded optimizer's new moment tensors, say)."""
        with self._lock:
            while self._entries:
                self._drop()

    def signature(self, batch: Dict, key=()):
        """The cache key of a call: ``key`` and each input's name, shape,
        dtype and device (a non-tensor value by itself)."""
        return (key, tuple(
            (name, tuple(v.shape), v.dtype, v.device)
            if isinstance(v, torch.Tensor) else (name, v)
            for name, v in batch.items()))

    def __call__(self, batch: Dict, key=()):
        sig = self.signature(batch, key)
        device = next(v.device for v in batch.values()
                      if isinstance(v, torch.Tensor))
        with self._lock:
            # a failed warm-up or capture leaves no entry behind
            entry = self._entries.pop(sig, None)
            if entry is None:
                entry = _Entry(BACKEND.context(device))
                t = time.perf_counter()
                with span("mdgat.graphs.warm_up"):
                    out = BACKEND.warm_up(self.fn, batch, entry.ctx)
                tick(TOTALS, "warm_up_s", _host_seconds(t))
                self._keep(sig, entry)
                tick(self, "warm_ups")
                return out
            if entry.replay is None:
                t = time.perf_counter()
                with span("mdgat.graphs.capture"):
                    entry.static = {k: torch.empty_like(v)
                                    if isinstance(v, torch.Tensor) else v
                                    for k, v in batch.items()}
                    entry.replay = BACKEND.capture(self.fn, entry.static,
                                                   entry.ctx)
                tick(TOTALS, "capture_s", _host_seconds(t))
                entry.pool_bytes = entry.ctx.get("pool_bytes", 0)
                _add_pool(entry.pool_bytes)
                tick(self, "captures")
            self._entries[sig] = entry          # now the most recent
            with span("mdgat.graphs.replay"):
                BACKEND.before_replay(entry.ctx, device)
                for k, v in batch.items():
                    if isinstance(v, torch.Tensor):
                        entry.static[k].copy_(v)
                out = _map(torch.clone, entry.replay())
                BACKEND.after_replay(entry.ctx, device)
            tick(self, "replays")
            return out

    def _keep(self, sig, entry):
        self._entries[sig] = entry
        while len(self._entries) > self.max_graphs:
            self._drop()

    def _drop(self):
        """Release the least recently used graph and take its pool off."""
        entry = self._entries.popitem(last=False)[1]
        BACKEND.release(entry.ctx)
        _add_pool(-entry.pool_bytes)
