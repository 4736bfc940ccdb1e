"""The ranks of a run: W ranks, one device each, in a ``(data, seq)`` grid.

Port of ``mdgat_tpu/parallel/mesh.py``. There a ``Mesh`` names the devices
and XLA places shards and inserts the collectives; here a process is a rank
with one device, and :class:`DataParallelGroup` holds what the training
step and the eval loops need to know about the run: its world size, this
rank, this rank's device, the process group of the BatchNorm, gradient and
loss collectives, and the gloo group of host vectors. With a ``seq`` axis
(context parallelism, ``--seq_parallel S``) the W ranks are ``D = W / S``
data rows of S members, rows major (``multihost.mesh_coords``); the group
then also records D, S, this rank's ``(d, s)`` and the process group of its
row's members, which carries the keypoint gathers.

Every cross-rank reduction of the port goes through :func:`all_reduce`,
and every seq gather through :func:`all_gather`; each counts itself by kind
in :data:`collective_counts`: the smoke test reads the counts of a training
step as it reads the kernels' launch counts. The kinds a training step
issues are ``layer_bn`` / ``layer_bn_backward`` (the whole-layer train
kernels, one each a layer call), ``bn`` / ``bn_backward`` (a plain
BatchNorm, two each a call), ``gradients`` and ``loss``; under a seq axis
also ``input_gather`` (the masks and the ground truth of the whole clouds,
once a forward), ``kv_gather`` / ``kv_gather_backward`` (both clouds' key
activations, once a GNN layer each way) and ``tail_gather`` /
``tail_gather_backward`` (the final descriptors, once a forward each way).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

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
    data: int              # data rows D
    seq: int               # seq members S of a data row
    data_index: int        # this rank's row d
    seq_index: int         # this rank's member s
    seq_group: object      # its row's members (None when S == 1)


def data_parallel_group(device, seq: int = 1) -> Optional[DataParallelGroup]:
    """The group of a joined multi-process run (``initialize_distributed``)
    with this rank on ``device``, or None for a one-process run. With
    ``seq`` > 1 every rank makes every data row's seq sub-group, in row
    order (a new group is a collective call), and keeps its own; a seq size
    that does not divide the ranks raises ``ValueError``."""
    if multihost.process_count() == 1:
        multihost.mesh_coords(seq)      # seq > 1 needs more than one rank
        return None
    rows, _, d, s = multihost.mesh_coords(seq)
    seq_group = None
    if seq > 1:
        for row in range(rows):
            g = dist.new_group(ranks=list(range(row * seq, (row + 1) * seq)))
            if row == d:
                seq_group = g
    return DataParallelGroup(dist.get_world_size(), dist.get_rank(),
                             torch.device(device), dist.group.WORLD,
                             multihost.host_group(), rows, seq, d, s,
                             seq_group)


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


def _gather_blocks(tensors, group, kind, dim):
    """Every member's blocks of ``tensors`` along ``dim``, member order,
    through one ``all_gather`` of the tensors packed along ``dim``."""
    widths = [t.shape[dim] for t in tensors]
    packed = torch.cat(tensors, dim).contiguous()
    parts = [torch.empty_like(packed) for _ in range(dist.get_world_size(group))]
    collective_counts[kind] += 1
    dist.all_gather(parts, packed, group=group)
    out, off = [], 0
    for w in widths:
        out.append(torch.cat([p.narrow(dim, off, w) for p in parts], dim))
        off += w
    return out


class _AllGather(torch.autograd.Function):
    """:func:`_gather_blocks` forward. Backward, the transpose of
    ``all_gather(tiled=True)``: the cotangents summed over the members (an
    all-reduce of the whole, which every backend has), this member's block
    kept."""

    @staticmethod
    def forward(ctx, group, kind, dim, *tensors):
        ctx.group, ctx.kind, ctx.dim = group, kind, dim
        ctx.widths = [t.shape[dim] for t in tensors]
        return tuple(_gather_blocks(tensors, group, kind, dim))

    @staticmethod
    def backward(ctx, *grads):
        dim, widths = ctx.dim, ctx.widths
        summed = torch.stack([
            torch.cat([g.narrow(dim, m * w, w) for g, w in zip(grads, widths)],
                      dim)
            for m in range(dist.get_world_size(ctx.group))])
        collective_counts[ctx.kind + "_backward"] += 1
        dist.all_reduce(summed, group=ctx.group)
        mine = summed[dist.get_rank(ctx.group)].split(widths, dim)
        return (None, None, None) + tuple(mine)


def all_gather(tensors: Union[torch.Tensor, Sequence[torch.Tensor]], group,
               kind: str, dim: int = 1):
    """Each tensor whole along ``dim``: the blocks every member of ``group``
    holds, in member order, through ONE collective counted under ``kind``
    (the tensors are packed along ``dim``: their dtypes and every other
    dimension must agree). A tensor or a sequence in, the same out.

    Differentiable in the floating-point tensors: the backward sums the
    cotangents over the members and keeps this member's block (the
    transpose of ``jax.lax.all_gather(tiled=True)``), one all-reduce
    counted under ``kind + "_backward"``. Boolean tensors travel as uint8."""
    single = isinstance(tensors, torch.Tensor)
    tensors = [tensors] if single else list(tensors)
    flags = [t.dtype == torch.bool for t in tensors]
    tensors = [t.to(torch.uint8) if f else t for t, f in zip(tensors, flags)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        out = _AllGather.apply(group, kind, dim, *tensors)
    else:
        out = _gather_blocks(tensors, group, kind, dim)
    out = [o.bool() if f else o for o, f in zip(out, flags)]
    return out[0] if single else out


SEQ_KEYS = ("keypoints0", "keypoints1", "descriptors0", "descriptors1",
            "scores0", "scores1", "gt_matches0", "gt_matches1", "mask0",
            "mask1", "kpts0_world", "kpts1_world")


def shard_batch(batch: Dict, rows: Optional[slice] = None,
                seq_block: Optional[Tuple[int, int]] = None) -> Dict:
    """The rows ``rows`` of a host or device batch (numpy arrays, tensors,
    or the ``sequence`` list): what :meth:`SparseDataset.batches` with
    ``rows=`` yields for the same global batch. ``seq_block`` ``(s, S)``
    also keeps seq member s's block of S along the keypoint axis of the
    keys the JAX package shards over ``seq`` (:data:`SEQ_KEYS`,
    ``mdgat_tpu/parallel/mesh.py``); the raw clouds, ``T_gt``, ``rep`` and
    the host keys stay whole. A keypoint count S does not divide raises
    ``ValueError``. Sliced tensors come back contiguous."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, (list, np.ndarray, torch.Tensor)):
            if rows is not None:
                v = v[rows]
            if seq_block is not None and k in SEQ_KEYS:
                v = v[:, multihost.seq_columns(v.shape[1], seq_block[1],
                                               seq_block[0])]
                if isinstance(v, torch.Tensor):
                    v = v.contiguous()
        out[k] = v
    return out


@torch.no_grad()
def replicate(module: torch.nn.Module, group: DataParallelGroup):
    """Broadcast every parameter and buffer of ``module`` from rank 0, in
    place: after ``create_train_state`` or a resume, every rank starts the
    run from rank 0's state, as ``replicate`` puts one state on every
    device in the JAX package."""
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t, src=0, group=group.group)
