"""The data- and context-parallel training step: W ranks compute the
global-batch step.

Port of ``mdgat_tpu/parallel/smap.py``'s ``make_shard_map_train_step`` over
a ``(data, seq)`` grid of ``W = D x S`` ranks. Each data row holds
``batch_size / D`` contiguous rows of every global batch
(``multihost.process_batch_rows``); with S > 1 each seq member of the row
holds a contiguous block of ``N / S`` keypoints of every cloud of those
rows (``mesh.shard_batch(seq_block=...)``), and the model gathers keys and
the tail's descriptors over the row's members (``models/mdgat.py``). The
cross-rank semantics are explicit:

* training-mode BatchNorm normalises with the global batch statistics: the
  model runs under ``ops/mlp.py::bn_cross_replica(group)`` over the whole
  world (every data row and seq member), so the plain BatchNorm and the
  whole-layer train kernels sum their statistics over the ranks (and,
  backward, the BatchNorm reduction vectors);
* the loss is the mean over the row's pairs. Under a seq axis the tail
  (scores, Sinkhorn, decision, loss) runs on the gathered descriptors, the
  same on every member of a row, so each member's loss is its row's whole
  loss: its cotangent is scaled by 1/S (``_scale_grad`` of the JAX package,
  here the seed of ``backward``), the gathers' backwards sum the key-side
  and tail cotangents over the members, and each member's gradients are its
  share of the row's gradient;
* after ``backward`` every gradient, in parameter order, goes into ONE
  flattened all-reduce over the world and is divided by D: the ``psum``
  over ``seq`` and the ``pmean`` over ``data`` in one collective. With
  equal shares the mean of the row means is the global mean, and the
  result is the global-batch gradient;
* the loss metric is summed over the world and divided by W, which is the
  mean over the rows (``pmean`` over ``data``; the members of a row hold
  the same loss), ``grad_norm`` is taken on the reduced gradients, and
  every rank runs the same Adam update on the same numbers, so the ranks
  stay bit-equal without a broadcast.

The collectives are explicit and issued in one order on every rank (the
per-layer BatchNorm ones and gathers from inside the forward and from
inside the autograd backward, then the gradients, then the loss): the step
is deterministic. ``DistributedDataParallel``'s bucket hooks would overlap
the gradient reduction with the backward, and race with the BatchNorm
collectives the backward issues itself.

Eval (``train/loop.py::make_eval_step(model, seq_group)``) uses the
running statistics: BatchNorm issues no collective, and under a seq axis
only the gathers run.

:func:`make_eval_runtime` is the one-process multi-device eval of the JAX
package's ``make_eval_runtime`` (``Matcher(data_parallel=N,
seq_parallel=M)``): N x M model replicas in one process, one thread and one
device a replica, the seq members of a data row joined by a
``parallel/local.py::LocalGroup``.
"""

from __future__ import annotations

import contextlib
import copy
import threading
from typing import Callable, Dict, Sequence

import torch

from mdgat_tpu_torch.parallel.local import GATHER_TIMEOUT_S, LocalGroup
from mdgat_tpu_torch.parallel.mesh import (DataParallelGroup, all_reduce,
                                           shard_batch)
from mdgat_tpu_torch.utils.graphs import Captured, use_graphs
from mdgat_tpu_torch.utils.profiling import span


def average_gradients(params, group: DataParallelGroup):
    """Replace each ``p.grad`` of ``params`` by its sum over the ranks
    divided by the data rows D (the mean over the ranks when S = 1): one
    flattened all-reduce in parameter order."""
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce(flat, group.group, "gradients")
    flat /= group.data
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


def make_data_parallel_train_step(group: DataParallelGroup) -> Callable:
    """``step(state, batch) -> (state, metrics)`` of one rank, ``batch``
    this rank's rows (and, under a seq axis, its keypoint block:
    ``shard_batch(..., seq_block=(s, S))`` of a batch whose ground truth was
    formed on the whole clouds) on its device; ``state`` is updated in place, and
    ``metrics`` (``loss``, ``grad_norm``) are the global batch's, the same
    on every rank."""

    def step(state, batch: Dict[str, torch.Tensor]):
        model, opt = state.model, state.optimizer
        model.train()
        opt.zero_grad(set_to_none=True)
        loss = model(batch, group=group.group,
                     seq_group=group.seq_group)["loss"].mean()
        # a seq member's loss is its row's whole loss: 1/S of its cotangent
        loss.backward(loss.new_tensor(1.0 / group.seq))
        params = [p for p in model.parameters() if p.grad is not None]
        average_gradients(params, group)
        grad_norm = torch.nn.utils.get_total_norm([p.grad for p in params])
        loss = all_reduce(loss.detach().clone(), group.group, "loss")
        opt.step()
        state.step += 1
        return state, {"loss": loss / group.world, "grad_norm": grad_norm}

    return step


def upload(batch: Dict[str, torch.Tensor], device,
           normalize: bool = False) -> Dict[str, torch.Tensor]:
    """``batch`` on ``device``; with ``normalize`` its ``descriptors0`` /
    ``descriptors1`` L2-normalised there, in place and in their dtype, each
    row divided by its norm floored at 1e-12 (padded rows stay zero): the
    Matcher's normalisation, over the whole padded batch or a grid cell's
    block of it (a norm is one keypoint's)."""
    with span("mdgat.data.upload"):
        batch = {k: v.to(device) for k, v in batch.items()}
    if normalize:
        with span("mdgat.data.normalize"):
            for key in ("descriptors0", "descriptors1"):
                d = batch[key]
                d.div_(torch.linalg.vector_norm(d, dim=-1, keepdim=True)
                       .clamp_min_(1e-12))
    return batch


def _rows(batch: Dict[str, torch.Tensor]) -> int:
    return next(iter(batch.values())).shape[0]


def make_eval_runtime(model, cfg, devices: Sequence) -> Callable:
    """``step(batch) -> outputs`` of the eval forward over a ``(data, seq)``
    grid of ``cfg.data_parallel`` x ``cfg.seq_parallel`` cells in one
    process: the one-process branch of the JAX package's
    ``make_eval_runtime``.

    ``devices`` (N x M of them, a device may repeat) are laid out data-major,
    cell ``(d, s)`` on ``devices[d * M + s]``, as the JAX package's
    ``make_mesh`` reshapes its devices. Each cell holds an eval-mode replica
    of ``model`` on its device with the same weights. ``step(batch, rows)``
    takes a batch of tensors whose row count N divides, on any device, of
    which the first ``rows`` (default all) are real and the rest fill; each
    cell uploads its block with :func:`upload`, which L2-normalises its
    descriptors there under ``step(..., normalize=True)``; data
    row ``d`` takes its contiguous block of rows and, under a seq axis,
    member ``s`` its block of each cloud's keypoints (``mesh.shard_batch``).
    The kernels compute a row the same at any row count but for the
    Sinkhorn forward's cluster plan, which every cell takes for ``rows``
    pairs (``ops/cuda/sinkhorn.py::plan_as``): one device's plan for the
    real pairs, so that the grid's outputs are one device's, bit for bit.
    Every cell runs its forward on its own thread (on the card on its own
    stream, without gradients); the members of a row gather over a
    :class:`~mdgat_tpu_torch.parallel.local.LocalGroup`, and each returns
    the whole clouds' outputs, of which member 0's are kept. The rows'
    outputs come back on the host, concatenated in row order. The first
    exception of a cell is re-raised once every thread has ended (a failed
    member breaks its row's barriers, whose waits give up after
    ``GATHER_TIMEOUT_S``); a thread still running that long after the
    others raises ``TimeoutError``.

    A 1 x 1 grid, or a config whose ``resolve_shard_map`` is false, is one
    forward of ``model`` on ``devices[0]`` (outputs on that device; its
    plan the batch's own), as the JAX package falls back to its plain
    step. ``step.replicas`` holds the grid's modules, ``[d][s]``.

    Where ``utils/graphs.py::use_graphs`` says so, the one-device forward
    and each cell of a data-only grid (M = 1) run through a
    :class:`~mdgat_tpu_torch.utils.graphs.Captured` of their own
    (``step.graphs``, ``[d]``): one CUDA graph a cell and shape bucket,
    keyed on the plan's pair count, captured on the cell's thread and
    replayed on its stream. A seq row stays eager: its members' barriers
    and copies sit between the layers."""
    n_data, n_seq = cfg.data_parallel, cfg.seq_parallel
    devices = [torch.device(d) for d in devices]
    if n_data < 1 or n_seq < 1:
        raise ValueError(f"a {n_data} x {n_seq} grid: each axis takes at "
                         "least 1")
    if len(devices) != n_data * n_seq:
        raise ValueError(f"a {n_data} x {n_seq} grid needs {n_data * n_seq} "
                         f"devices, got {len(devices)}")
    from mdgat_tpu_torch.ops.cuda.sinkhorn import plan_as
    first = model.to(devices[0]).eval()
    if n_data * n_seq == 1 or not cfg.resolve_shard_map(n_data):
        graphs = Captured(first)

        def single(batch, rows=None, normalize=False):
            rows = rows or _rows(batch)
            with torch.inference_mode(), plan_as(rows):
                return _forward(first, graphs,
                                upload(batch, devices[0], normalize), rows)
        single.replicas, single.graphs = [[first]], [graphs]
        return single

    replicas = [[first if d == s == 0 else
                 copy.deepcopy(first).to(devices[d * n_seq + s]).eval()
                 for s in range(n_seq)] for d in range(n_data)]
    graphs = [Captured(row[0]) for row in replicas] if n_seq == 1 else []

    def cell(d, s, batch, rows, real, normalize, group, kept, errors, lock):
        device = devices[d * n_seq + s]
        try:
            shard = shard_batch(batch, rows=slice(d * rows, (d + 1) * rows),
                                seq_block=(s, n_seq) if n_seq > 1 else None)
            with contextlib.ExitStack() as stack:
                # grad mode, the current device and stream and the plan are
                # per thread
                stack.enter_context(torch.inference_mode())
                stack.enter_context(plan_as(real))
                if device.type == "cuda":
                    stack.enter_context(torch.cuda.device(device))
                    stack.enter_context(
                        torch.cuda.stream(torch.cuda.Stream(device)))
                shard = upload(shard, device, normalize)
                if group is not None:
                    stack.enter_context(group.member(s))
                    out = replicas[d][s](shard, seq_group=group)
                else:
                    out = _forward(replicas[d][0], graphs[d], shard, real)
                if s == 0:
                    kept[d] = {k: v.cpu() for k, v in out.items()}
                elif device.type == "cuda":
                    torch.cuda.current_stream(device).synchronize()
        except BaseException as e:  # noqa: BLE001 — re-raised by step
            with lock:
                errors.append(e)
            if group is not None:
                group.abort()

    def step(batch, rows=None, normalize=False):
        b = _rows(batch)
        if b % n_data:
            raise ValueError(f"{b} rows do not split over {n_data} data "
                             "replicas (pad the batch to a multiple)")
        kept, errors, lock = [None] * n_data, [], threading.Lock()
        threads = []
        for d in range(n_data):
            group = (LocalGroup(devices[d * n_seq:(d + 1) * n_seq])
                     if n_seq > 1 else None)
            threads += [threading.Thread(
                target=cell, args=(d, s, batch, b // n_data, rows or b,
                                   normalize, group, kept, errors, lock),
                name=f"mdgat-eval-{d}-{s}", daemon=True)
                for s in range(n_seq)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(GATHER_TIMEOUT_S)
        if errors:
            raise errors[0]
        if any(t.is_alive() for t in threads):
            raise TimeoutError(f"an eval replica ran over {GATHER_TIMEOUT_S} "
                               "s")
        return {k: torch.cat([out[k] for out in kept]) for k in kept[0]}

    step.replicas, step.graphs = replicas, graphs
    return step


def _forward(model, graphs, batch, rows):
    """``model``'s eval forward of ``batch`` on one device, through
    ``graphs`` where ``use_graphs`` says so (keyed on the plan's ``rows``),
    else eagerly."""
    if use_graphs(model.config, model.bin_score.device, batch):
        return graphs(batch, key=("eval", rows, model.config.exact_topk))
    return model(batch)
