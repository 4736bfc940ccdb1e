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
only the gathers run. The one-process multi-device eval runtime is not
ported.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from mdgat_tpu_torch.parallel.mesh import DataParallelGroup, all_reduce


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
