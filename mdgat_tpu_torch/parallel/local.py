"""The seq members of one data row as threads of one process.

The JAX package's ``Matcher(seq_parallel=M)`` runs the seq axis of a local
device mesh inside one process (``mdgat_tpu/parallel/smap.py``,
``make_eval_runtime``). A :class:`LocalGroup` is its counterpart in the
port: M members, each run by its own thread on its own device (a device
may repeat: members can share one card), taking the place of the process
group of a multi-process seq row. ``parallel/mesh.py::all_gather`` takes
either, so ``models/gnn.py`` and ``models/mdgat.py`` run a member's forward
unchanged.

:meth:`LocalGroup.all_gather` posts this member's packed block in its slot,
waits at a ``threading.Barrier`` for every member's, copies the other
members' blocks onto its own device, and waits at a second barrier before
any slot can be posted again. On the card each member enqueues on its own
stream: a posted block carries an event recorded on its producer's stream,
which the copy's stream waits on, and the block is marked used on that
stream (``record_stream``), so that the caching allocator does not hand its
memory out again before the copy has run. Members of one call launch the
same kernels at the same shapes.

Eval only: a gather's backward raises (nothing in the JAX ``Matcher``
differentiates through one). A member that fails calls :meth:`abort`: the
others then leave their barrier with ``threading.BrokenBarrierError``
instead of waiting, and every wait gives up after ``timeout`` seconds.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Sequence

import torch

# seconds a member waits at a barrier for the others
GATHER_TIMEOUT_S = 300.0


class LocalGroup:
    """M members of one process, member ``s`` on ``devices[s]``. A thread
    runs as a member inside :meth:`member`."""

    def __init__(self, devices: Sequence, timeout: float = GATHER_TIMEOUT_S):
        self.devices = [torch.device(d) for d in devices]
        self.size = len(self.devices)
        self._barrier = threading.Barrier(self.size, timeout=timeout)
        self._slots: List = [None] * self.size
        self._bound = threading.local()

    @contextlib.contextmanager
    def member(self, index: int):
        """Run the calling thread as member ``index`` inside the block."""
        self._bound.index = index
        try:
            yield self
        finally:
            del self._bound.index

    def rank(self) -> int:
        """The calling thread's member index."""
        index = getattr(self._bound, "index", None)
        if index is None:
            raise RuntimeError("LocalGroup: the calling thread is not a "
                               "member (enter LocalGroup.member(s) first)")
        return index

    def abort(self):
        """Break the barriers: every member waiting or about to wait raises
        ``threading.BrokenBarrierError``."""
        self._barrier.abort()

    def all_gather(self, packed: torch.Tensor) -> List[torch.Tensor]:
        """Every member's ``packed`` (equal shapes and dtypes), in member
        order, on this member's device."""
        me = self.rank()
        ready = None
        if packed.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(packed.device))
        self._slots[me] = (packed, ready)
        self._barrier.wait()
        parts = [packed if j == me else _receive(block, ready_j,
                                                 self.devices[me])
                 for j, (block, ready_j) in enumerate(self._slots)]
        self._barrier.wait()        # every copy is enqueued: slots reusable
        return parts


def _receive(block: torch.Tensor, ready, device: torch.device):
    """``block`` on ``device``, ordered after the producer's ``ready``
    event. The copy runs on the calling thread's stream of the block's
    device (this member's own stream when the devices agree: then the block
    itself is returned and read there)."""
    if ready is None:
        return block.to(device)
    stream = torch.cuda.current_stream(block.device)
    stream.wait_event(ready)
    out = block.to(device, non_blocking=True)
    block.record_stream(stream)
    return out
