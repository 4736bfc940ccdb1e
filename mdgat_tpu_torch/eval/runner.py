"""Pipelined evaluation loop of the eval entry points.

Port of ``mdgat_tpu/eval/runner.py``. The reference evaluates strictly
serially: load a pair, forward, host metrics (``test.py:190-203``), so the
device idles during host IO and metrics and the host idles during device
compute. This loop overlaps three stages:

1. a producer thread runs disk IO and fixed-shape batching
   (``SparseDataset.batches``) into a bounded queue;
2. the main thread enqueues batch i+1's host-to-device copies (from pinned
   memory, ``non_blocking``), its preprocessing and its eval forward; CUDA
   launches return at once, as JAX dispatch does;
3. only then are batch i's small outputs (``matches0``, the ground truth,
   not the whole output dict) copied to the host, the one host sync a
   batch, while batch i+1 computes; host metrics then run on numpy.

Printed metrics are unchanged; only the schedule differs. A remainder batch
is padded to the full batch size by repeating its last pair and trimmed
again before the yield, so that every batch of a bucket has one shape.
``pair_range`` restricts the pipeline to one eval rank's block of pairs
(``parallel/multihost.py::eval_pair_range``). Under a seq axis the members
of a data row take the row's block, prepare each batch whole (the ground
truth is formed on the whole clouds), and run the eval step on their own
keypoint block (``make_shard_map_eval_step`` with ``shard_inputs`` of the
JAX package); the outputs are the whole clouds'. The eval CLIs run one
device a rank; one process over several devices is ``Matcher``'s
(``parallel/smap.py::make_eval_runtime``).
"""

from __future__ import annotations

import itertools
import os
import queue
import threading
from typing import Dict, Iterator, Sequence, Tuple

import numpy as np
import torch

from mdgat_tpu_torch.core.checkpoint import (load_npz, load_pth_state_dict,
                                             state_dict_from_numpy)
from mdgat_tpu_torch.data.pipeline import (SparseDataset, model_inputs,
                                           prepare_batch)
from mdgat_tpu_torch.models.factory import build_model
from mdgat_tpu_torch.models.mdgat import torch_dtype
from mdgat_tpu_torch.parallel.mesh import shard_batch
from mdgat_tpu_torch.parallel.multihost import eval_pair_range
from mdgat_tpu_torch.train.loop import make_eval_step
from mdgat_tpu_torch.utils.profiling import span


def eval_model(cfg, device):
    """The eval model of ``cfg`` on ``device`` in eval mode, and where its
    weights came from: ``"pth"`` (a reference or port ``.pth``), ``"npz"``
    (the JAX package's checkpoint), ``"missing"`` (``cfg.resume_model``
    names no file) or ``"none"`` (a file that is neither). The last two are
    a seeded init (``cfg.seed``), as the JAX eval CLIs do; they print their
    own warnings. A CUDA device that is absent raises."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {device}: no CUDA device")
        # full-precision f32 products on the card (TF32 keeps ~3 digits)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    model = build_model(cfg)
    path = cfg.resume_model
    if not os.path.exists(path):
        source = "missing"
    elif path.endswith(".pth"):
        source = "pth"
        model.load_state_dict(load_pth_state_dict(path), strict=True)
    elif path.endswith(".npz"):
        source = "npz"
        params, bn_state, _ = load_npz(path)
        model.load_state_dict(state_dict_from_numpy(params, bn_state, cfg),
                              strict=True)
    else:
        source = "none"
    if source in ("missing", "none"):
        model.reset_parameters(cfg.seed)
    return model.to(device).eval(), source


def eval_pipeline(cfg, model, device, fetch: Sequence[str], group=None,
                  max_pairs: int = 0) -> "EvalPipeline":
    """The eval CLIs' pipeline over the test split of ``cfg``: host batches
    of ``cfg.batch_size`` pairs, ``prepare_batch`` on ``device`` (ground
    truth at float64 when the model computes in it, float32 otherwise),
    ``model``'s eval forward, ``fetch`` outputs and ``gt_matches0`` read
    back. With ``group`` (a multi-process run's ``DataParallelGroup``) only
    this rank's data row's block of the first ``max_pairs`` pairs
    (``eval_pair_range``; 0 = all), and under a seq axis the forward on
    this member's keypoint block."""
    compute_dtype = torch_dtype(cfg.compute_dtype)
    gt_dtype = (torch.float64 if cfg.compute_dtype == "float64"
                else torch.float32)

    def prepare(batch):
        return prepare_batch(batch, cfg.threshold, cfg.mutual_check, device,
                             compute_dtype, gt_dtype)

    dataset = SparseDataset(cfg, "test")
    if group is None:
        return EvalPipeline(dataset, prepare, make_eval_step(model),
                            cfg.batch_size, fetch=fetch)
    pair_range = eval_pair_range(len(dataset), max_pairs, cfg.batch_size,
                                 seq=group.seq)
    block = (group.seq_index, group.seq) if group.seq > 1 else None
    eval_step = make_eval_step(model, group.seq_group)
    return EvalPipeline(
        dataset, prepare,
        lambda inputs: eval_step(shard_batch(inputs, seq_block=block)),
        cfg.batch_size, fetch=fetch, pair_range=pair_range)


def timing_lines(n_pairs: int, seconds: float, first_batch_s, n_batches: int):
    """The eval CLIs' ``[timing]`` lines (``test.py``'s format): pairs/s over
    the pipeline loop, then the first batch apart (start-up: IO, weight
    preparation, kernels built at first use) and the steady rate after it."""
    lines = [f"[timing] {n_pairs} pairs in {seconds:.2f}s = "
             f"{n_pairs / seconds:.1f} pairs/s"]
    if first_batch_s is not None and n_batches > 1:
        steady = seconds - first_batch_s
        per_batch = steady / (n_batches - 1)
        lines.append(
            f"[timing] first batch {first_batch_s:.2f}s (start-up: IO, weight "
            f"preparation, kernels built at first use), then {n_batches - 1} "
            f"batches in {steady:.2f}s = {per_batch:.3f} s/batch "
            f"({(n_pairs / n_batches) / per_batch:.0f} pairs/s steady-state)")
    return lines


class EvalPipeline:
    """Iterates (host_batch, host_outputs) over a dataset split.

    ``prepare(batch)`` turns a host batch into the model's inputs on the
    device (``data/pipeline.py::prepare_batch``), ``eval_step(inputs)`` runs
    the forward (``train/loop.py::make_eval_step``). ``host_outputs`` holds
    the ``fetch`` outputs and ``gt_matches0`` as numpy arrays. The producer
    runs at most two batches ahead. ``pair_range`` ``(lo, hi)`` evaluates
    that block of the pair list only.
    """

    def __init__(self, dataset, prepare, eval_step, batch_size: int,
                 fetch: Sequence[str] = ("matches0",), pair_range=None):
        self.dataset = dataset
        self.prepare = prepare
        self.eval_step = eval_step
        self.batch_size = batch_size
        self.fetch = tuple(fetch)
        self.pair_range = pair_range

    def _produce(self, q: queue.Queue, stop: threading.Event):
        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        try:
            # pair_range only when set: a one-process caller's dataset needs
            # no more than batches(batch_size, shuffle, drop_last)
            kw = ({} if self.pair_range is None
                  else {"pair_range": self.pair_range})
            for batch in self.dataset.batches(self.batch_size, shuffle=False,
                                              drop_last=False, **kw):
                if not put(self._pad_tail(batch)):
                    return
            put(None)
        except BaseException as e:  # noqa: BLE001 — re-raised in __iter__
            # an IO or shape error must reach the consumer: swallowing it
            # would truncate the dataset and print plausible aggregates of
            # a partial eval
            put(e)

    def _pad_tail(self, batch: Dict) -> Dict:
        """Pad a remainder batch to the full batch size by repeating its
        last pair (``__n_real__`` holds the real count; the extra rows are
        trimmed before the yield)."""
        n = len(batch["idx0"])
        if n == self.batch_size:
            return batch
        pad = self.batch_size - n
        out = {"__n_real__": n}
        for k, v in batch.items():
            if isinstance(v, list):
                out[k] = v + [v[-1]] * pad
            else:
                v = np.asarray(v)
                out[k] = np.concatenate(
                    [v, np.repeat(v[-1:], pad, axis=0)], axis=0)
        return out

    def __iter__(self) -> Iterator[Tuple[Dict, Dict[str, np.ndarray]]]:
        q: queue.Queue = queue.Queue(maxsize=2)
        stop = threading.Event()    # set when the consumer stops early
        threading.Thread(target=self._produce, args=(q, stop),
                         daemon=True).start()

        def emit(item):
            batch, small = item
            with span("mdgat.data.readback"):
                got = {k: v.cpu().numpy() for k, v in small.items()}
            n_real = batch.pop("__n_real__", None)
            if n_real is not None:
                batch = {k: v[:n_real] for k, v in batch.items()}
                got = {k: v[:n_real] for k, v in got.items()}
            return batch, got

        pending = None
        try:
            for index in itertools.count():
                ready = None
                with span("mdgat.entry.eval_batch", index):
                    with span("mdgat.data.wait"):
                        batch = q.get()
                    if batch is None:
                        break
                    if isinstance(batch, BaseException):
                        raise batch
                    n_real = batch.pop("__n_real__", None)
                    prepared = self.prepare(batch)
                    if n_real is not None:
                        batch["__n_real__"] = n_real
                    out = self.eval_step(model_inputs(prepared))
                    small = {k: out[k] for k in self.fetch}
                    small["gt_matches0"] = prepared["gt_matches0"]
                    # batch i+1 is enqueued on the device: read batch i back
                    if pending is not None:
                        ready = emit(pending)
                    pending = (batch, small)
                if ready is not None:
                    yield ready
            if pending is not None:
                yield emit(pending)
        finally:
            stop.set()
