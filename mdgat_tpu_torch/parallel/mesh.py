"""The data-parallel group: W ranks, one device each, one batch shard each.

Port of ``mdgat_tpu/parallel/mesh.py``. There a ``Mesh`` names the devices
and XLA places shards and inserts the collectives; here a process is a rank
with one device, and :class:`DataParallelGroup` holds what the training
step and the eval loops need to know about the run: its world size, this
rank, this rank's device, the process group of the BatchNorm, gradient and
loss collectives, and the gloo group of host vectors.

Every cross-rank reduction of the port goes through :func:`all_reduce`,
which counts it by kind in :data:`collective_counts`: the smoke test reads
the counts of a training step as it reads the kernels' launch counts. The
kinds a training step issues are ``layer_bn`` / ``layer_bn_backward`` (the
whole-layer train kernels, one each a layer call), ``bn`` /
``bn_backward`` (a plain BatchNorm, two each a call), ``gradients`` and
``loss``.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn

from mdgat_tpu_torch.parallel import multihost

# cross-rank reductions by kind, since the last reset (``.clear()``)
collective_counts: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class DataParallelGroup:
    world: int
    rank: int
    device: torch.device
    group: object          # BatchNorm, gradient and loss collectives
    host_group: object     # host vectors (gloo)


def data_parallel_group(device) -> Optional[DataParallelGroup]:
    """The group of a joined multi-process run (``initialize_distributed``)
    with this rank on ``device``, or None for a one-process run."""
    if multihost.process_count() == 1:
        return None
    return DataParallelGroup(dist.get_world_size(), dist.get_rank(),
                             torch.device(device), dist.group.WORLD,
                             multihost.host_group())


def all_reduce(t: torch.Tensor, group, kind: str,
               differentiable: bool = False) -> torch.Tensor:
    """The sum of ``t`` over the group's ranks, counted under ``kind``.

    ``differentiable=False`` reduces in place and returns ``t``. With
    ``differentiable=True`` the sum is a new tensor whose backward sums its
    cotangents over the ranks (``torch.distributed.nn.functional``), as the
    transpose of a ``psum`` does; that backward reduction is counted under
    ``kind + "_backward"`` when autograd reaches it."""
    collective_counts[kind] += 1
    if not differentiable:
        dist.all_reduce(t, group=group)
        return t
    out = dist_nn.all_reduce(t, group=group)
    if out.requires_grad:
        out.register_hook(
            lambda g: collective_counts.update([kind + "_backward"]))
    return out


def shard_batch(batch: Dict, rows: slice) -> Dict:
    """The rows ``rows`` of a host batch (numpy arrays, tensors, or the
    ``sequence`` list): what :meth:`SparseDataset.batches` with ``rows=``
    yields for the same global batch."""
    return {k: (v[rows] if isinstance(v, (list, np.ndarray, torch.Tensor))
                else v) for k, v in batch.items()}


@torch.no_grad()
def replicate(module: torch.nn.Module, group: DataParallelGroup):
    """Broadcast every parameter and buffer of ``module`` from rank 0, in
    place: after ``create_train_state`` or a resume, every rank starts the
    run from rank 0's state, as ``replicate`` puts one state on every
    device in the JAX package."""
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t, src=0, group=group.group)
