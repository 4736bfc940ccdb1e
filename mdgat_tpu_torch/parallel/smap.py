"""The data-parallel training step: W ranks compute the global-batch step.

Port of ``mdgat_tpu/parallel/smap.py``'s ``make_shard_map_train_step`` over
a ``data`` axis of W devices. Each rank holds ``batch_size / W`` contiguous
rows of every global batch (``multihost.process_batch_rows``) and runs the
model on them, kernels included, with the cross-rank semantics explicit:

* training-mode BatchNorm normalises with the global batch statistics: the
  model runs under ``ops/mlp.py::bn_cross_replica(group)``, so the plain
  BatchNorm and the whole-layer train kernels sum their statistics over the
  ranks (and, backward, the BatchNorm reduction vectors);
* the loss is the mean over the rank's rows; after ``backward`` every
  gradient, in parameter order, goes into ONE flattened all-reduce and is
  divided by W (the ``pmean``). With equal shares the mean of the rank
  means is the global mean, and the averaged gradients are the global-batch
  gradients;
* the loss metric is averaged the same way, ``grad_norm`` is taken on the
  averaged gradients, and every rank runs the same Adam update on the same
  numbers, so the ranks stay bit-equal without a broadcast.

The collectives are explicit and issued in one order on every rank (the
per-layer BatchNorm ones from inside the forward and from inside the
autograd backward, then the gradients, then the loss): the step is
deterministic. ``DistributedDataParallel``'s bucket hooks would overlap the
gradient reduction with the backward, and race with the BatchNorm
collectives the backward issues itself.

Eval needs no step of its own: in eval mode BatchNorm uses the running
statistics and no collective runs, so each rank runs
``train/loop.py::make_eval_step`` on its rows. The ``seq`` (context-
parallel) axis and the one-process multi-device eval runtime are not
ported.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from mdgat_tpu_torch.parallel.mesh import DataParallelGroup, all_reduce


def average_gradients(params, group: DataParallelGroup):
    """Replace each ``p.grad`` of ``params`` by its mean over the ranks:
    one flattened all-reduce in parameter order, then ``/ W``."""
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce(flat, group.group, "gradients")
    flat /= group.world
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


def make_data_parallel_train_step(group: DataParallelGroup) -> Callable:
    """``step(state, batch) -> (state, metrics)`` of one rank, ``batch``
    this rank's rows on its device; ``state`` is updated in place, and
    ``metrics`` (``loss``, ``grad_norm``) are the global batch's, the same
    on every rank."""

    def step(state, batch: Dict[str, torch.Tensor]):
        model, opt = state.model, state.optimizer
        model.train()
        opt.zero_grad(set_to_none=True)
        loss = model(batch, group=group.group)["loss"].mean()
        loss.backward()
        params = [p for p in model.parameters() if p.grad is not None]
        average_gradients(params, group)
        grad_norm = torch.nn.utils.get_total_norm([p.grad for p in params])
        loss = all_reduce(loss.detach().clone(), group.group, "loss")
        opt.step()
        state.step += 1
        return state, {"loss": loss / group.world, "grad_norm": grad_norm}

    return step
