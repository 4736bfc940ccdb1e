"""Attentional GNN with the multiplex-dynamic-graph k-schedule.

Port of ``mdgat_tpu/models/gnn.py`` (reference ``AttentionalPropagation`` /
``AttentionalGNN``, ``models/mdgat.py:239-276``): 2L alternating self and
cross layers, each ``x += MLP(cat(x, MHA(x, source)))``; late layers use
dynamic top-k attention per the k-schedule. Self layers attend to the
cloud itself, cross layers to the other cloud; a layer's weights serve
both clouds, and both clouds read the descriptors from before the layer.

Eval mode: on a CUDA tensor with ``use_kernels`` each layer runs the
whole-layer kernels (``ops/cuda/layer.py``) on weights prepared once per
model (cached here until a parameter or buffer changes); otherwise the
plain path.

The kernel routes below select the top-k with the attention kernel's fast
arm unless ``exact_topk`` (the JAX package's ``pallas_exact_topk``); the
plain path is exact either way, as the JAX package's XLA path is. With
``kernel_twins`` a CPU tensor takes the kernel routes too, on the wrappers'
plain twins (the JAX package's ``pallas_interpret``).

Training mode (``module.train()``): a layer is applied to cloud 0, then to
cloud 1, both from the descriptors before the layer, so its BatchNorm sees
per-cloud batch statistics and its running stats move twice per layer
(``models/gnn.py:95-96``, ``:133-139`` of the JAX package). Three routes, as
there:

* ``use_kernels`` and ``train_layer`` (the default): the whole layer,
  residual included, is ``fused_train_layer_apply``
  (``ops/cuda/train_layer.py``): hand-written kernels forward and backward
  on a CUDA tensor, their plain twin on a CPU tensor. Its variance is
  single-pass. No size gate: a shape the kernels cannot take raises.
* ``use_kernels`` without ``train_layer``: ``fused_mha`` (the kernel pair
  of ``ops/cuda/mha.py`` on a CUDA tensor) followed by the plain MLP with
  train-mode BatchNorm and the residual (``pallas_train_layer=False``).
* otherwise the plain path under autograd.

Under a data-parallel step the BatchNorm statistics of every route are the
global batch's (``ops/mlp.py::bn_cross_replica``), and each cross-rank
reduction is a collective: every rank must run every layer call, both
clouds, in the same order, or the ranks wait on each other forever.

Context parallelism (``seq_group``, the JAX package's ``seq_axis``): the
clouds' keypoint axes are split over the members of a seq group. Query rows
stay local; at every layer both clouds' descriptors from before the layer
are gathered whole over the group in one collective (``kv_gather``,
``parallel/mesh.py::all_gather``; its backward sums the key-side cotangents
over the members), so every route above runs B x N/S query rows against B x
N keys, under the key masks of the whole clouds, and BatchNorm statistics
over every rank's rows (the group of ``bn_cross_replica`` is the world).

The layer-pair scan and remat have no counterpart: PyTorch runs eagerly.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from mdgat_tpu_torch.ops.attention import multi_head_attention
from mdgat_tpu_torch.ops.cuda.layer import (LayerWeights, fused_layer,
                                            prepare_layer_weights)
from mdgat_tpu_torch.ops.cuda.train_layer import fused_train_layer_apply
from mdgat_tpu_torch.ops.mlp import Conv1x1, apply_mlp, mlp, reset_mlp
from mdgat_tpu_torch.parallel.mesh import all_gather


class MultiHeadedAttention(nn.Module):
    """The reference's ``attn`` submodule: ``proj`` (q, k, v) and
    ``merge``, all 1x1 convs."""

    def __init__(self, d: int, *, dtype: torch.dtype, device=None):
        super().__init__()
        self.proj = nn.ModuleList([Conv1x1(d, d, dtype=dtype, device=device)
                                   for _ in range(3)])
        self.merge = Conv1x1(d, d, dtype=dtype, device=device)


class AttentionalPropagation(nn.Module):
    def __init__(self, feature_dim: int, num_heads: int, *,
                 dtype: torch.dtype, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.attn = MultiHeadedAttention(feature_dim, dtype=dtype,
                                         device=device)
        self.mlp = mlp([feature_dim * 2, feature_dim * 2, feature_dim],
                       dtype=dtype, device=device)
        self._kernel_weights: Optional[LayerWeights] = None
        self._kernel_key = None

    def forward(self, x, source, topk: Optional[int],
                kv_mask: Optional[torch.Tensor] = None,
                valid_mask: Optional[torch.Tensor] = None,
                use_kernels: bool = False, exact: bool = True,
                kernel_twins: bool = False) -> torch.Tensor:
        """The residual update ``MLP(cat(x, MHA(x, source)))`` (concat-free
        first conv). ``valid_mask`` marks the valid points of ``x`` for the
        training-mode BN statistics; ``use_kernels`` routes the attention
        of a CUDA tensor (any tensor with ``kernel_twins``) to the fused-MHA
        kernel pair, whose selection is exact or the fast arm."""
        message = multi_head_attention(self.attn, x, source, topk,
                                       self.num_heads, kv_mask=kv_mask,
                                       use_kernels=use_kernels, exact=exact,
                                       kernel_twins=kernel_twins)
        return apply_mlp(self.mlp, (x, message), valid_mask)

    def kernel_weights(self) -> LayerWeights:
        """Kernel operands, prepared on first use and again only after a
        parameter or buffer changed (moved, loaded or edited in place)."""
        key = tuple((t.data_ptr(), t._version)
                    for t in list(self.parameters()) + list(self.buffers()))
        if self._kernel_key != key:
            self._kernel_weights = prepare_layer_weights(self, torch.float32)
            self._kernel_key = key
        return self._kernel_weights

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        for conv in list(self.attn.proj) + [self.attn.merge]:
            conv.reset_parameters(generator)
        reset_mlp(self.mlp, generator, zero_last_bias=True)


class AttentionalGNN(nn.Module):
    def __init__(self, feature_dim: int, layer_names: Sequence[str],
                 num_heads: int, *, dtype: torch.dtype, device=None):
        super().__init__()
        self.names: List[str] = list(layer_names)
        self.layers = nn.ModuleList([
            AttentionalPropagation(feature_dim, num_heads, dtype=dtype,
                                   device=device)
            for _ in self.names])

    def forward(self, desc0, desc1, k_schedule: Sequence[Optional[int]],
                mask0: Optional[torch.Tensor] = None,
                mask1: Optional[torch.Tensor] = None,
                use_kernels: bool = True, train_layer: bool = True,
                seq_group=None, key_masks=None, exact_topk: bool = False,
                kernel_twins: bool = False):
        """``desc0`` / ``desc1`` [B, N, D] and their row masks [B, N]. With
        ``seq_group`` they hold this member's block of each cloud's rows,
        and ``key_masks`` are the masks of the whole clouds."""
        kernels = use_kernels and (desc0.device.type == "cuda" or kernel_twins)
        exact = exact_topk or not kernels    # the plain path is exact
        kmask0, kmask1 = (mask0, mask1) if seq_group is None else key_masks
        for layer, name, k in zip(self.layers, self.names, k_schedule):
            keys0, keys1 = desc0, desc1
            if seq_group is not None:
                keys0, keys1 = all_gather((desc0, desc1), seq_group,
                                          "kv_gather")
            if name == "cross":
                src0, src1, kvm0, kvm1 = keys1, keys0, kmask1, kmask0
            else:
                src0, src1, kvm0, kvm1 = keys0, keys1, kmask0, kmask1
            if self.training and use_kernels and train_layer:
                # the residual is inside the fused layer; cloud 0 first
                desc0, desc1 = (
                    fused_train_layer_apply(layer, desc0, src0, k, kvm0, mask0,
                                            exact),
                    fused_train_layer_apply(layer, desc1, src1, k, kvm1, mask1,
                                            exact))
            elif self.training:
                # cloud 0 first: the BN running stats move in that order
                delta0 = layer(desc0, src0, k, kvm0, mask0, use_kernels,
                               exact, kernel_twins)
                delta1 = layer(desc1, src1, k, kvm1, mask1, use_kernels,
                               exact, kernel_twins)
                desc0, desc1 = desc0 + delta0, desc1 + delta1
            elif kernels:
                w = layer.kernel_weights()
                desc0, desc1 = (fused_layer(desc0, src0, kvm0, k, w, exact),
                                fused_layer(desc1, src1, kvm1, k, w, exact))
            else:
                desc0, desc1 = (desc0 + layer(desc0, src0, k, kvm0),
                                desc1 + layer(desc1, src1, k, kvm1))
        return desc0, desc1
