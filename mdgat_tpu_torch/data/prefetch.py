"""Background-thread batch prefetch for the training loop.

The reference overlaps disk IO with GPU compute through
``torch.utils.data.DataLoader(..., num_workers=1, drop_last=True)``
(reference ``train.py:166-171``); without it the host assembles each
batch (disk reads, padding, numpy stacking) while the device sits idle.
Here a single producer thread runs the host-side batch assembly
(:meth:`SparseDataset.batches`) a bounded number of batches ahead, while
the main thread keeps the device queue full with prepare / train-step
launches (CUDA launches are asynchronous, so the main thread returns to
``q.get`` as soon as a step is enqueued).

A copy of ``mdgat_tpu/data/prefetch.py`` (pure Python; the consumer's wait
is the span ``mdgat.data.wait``). Producer exceptions
propagate to the consumer: a mid-dataset IO error surfaces instead of
silently truncating the epoch. Training needs no per-step readback (losses
stay on the device until the epoch ends), so prefetching the host batches
is the whole job.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

from mdgat_tpu_torch.utils.profiling import span

_SENTINEL = object()


class BatchPrefetcher:
    """Re-iterable wrapper running ``make_iter()`` in a producer thread.

    ``make_iter`` is a zero-arg callable returning a fresh iterator
    (e.g. ``lambda: dataset.batches(bs, shuffle=True, seed=s)``) so one
    prefetcher can drive several epochs; each ``__iter__`` call starts
    its own thread and bounded queue of ``depth`` batches. Yields exactly
    the items ``make_iter()`` would, in order; re-raises any producer
    exception at the point of consumption. Abandoning the iterator
    mid-epoch stops the producer promptly (bounded-timeout puts against
    a stop flag) instead of leaking a blocked thread.
    """

    def __init__(self, make_iter: Callable[[], Iterable], depth: int = 2):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._make_iter = make_iter
        self._depth = depth

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self._depth)
        stop = threading.Event()

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def _produce():
            try:
                for item in self._make_iter():
                    if not _put(item):
                        return
            except BaseException as e:  # re-raised consumer-side
                _put(e)
                return
            _put(_SENTINEL)

        t = threading.Thread(target=_produce, daemon=True,
                             name="batch-prefetch")
        t.start()
        try:
            while True:
                with span("mdgat.data.wait"):
                    item = q.get()
                if item is _SENTINEL:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()


def prefetch_batches(make_iter: Callable[[], Iterable],
                     depth: int = 2) -> Iterable:
    """``make_iter()`` items, produced ``depth`` ahead on a thread.

    ``depth=0`` disables prefetching (returns ``make_iter()`` directly) —
    the ``--prefetch 0`` escape hatch for strictly serial debugging.
    """
    if depth <= 0:
        return self_iter(make_iter)
    return BatchPrefetcher(make_iter, depth)


def self_iter(make_iter: Callable[[], Iterable]) -> Iterable:
    """Direct (non-threaded) iteration with the same re-iterable shape."""

    class _Direct:
        def __iter__(self):
            return iter(make_iter())

    return _Direct()
