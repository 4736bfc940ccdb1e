"""Keypoint and descriptor encoders (``models/mdgat.py:144-188``,
``models/superglue.py:199-219``).

Port of ``mdgat_tpu/models/encoders.py``: point-wise MLPs over ``[B, N, C]``
with the reference's zero-initialised final bias. In training mode
``valid_mask`` keeps padded points out of the BatchNorm statistics, and out
of the global max-pool of the two global-aware encoders (the ``-1e30``
sentinel). Module and attribute names (``encoder``, ``encoder2``) follow the
reference so the state-dict keys are ``kenc.encoder.*``, ``denc.encoder.*``
and ``denc.encoder2.*``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from mdgat_tpu_torch.ops.mlp import apply_mlp, mlp, reset_mlp


class KeypointEncoder(nn.Module):
    """MLP([4, *layers, D]) over ``cat(xyz, score)``."""

    def __init__(self, feature_dim: int, layers: Sequence[int], *,
                 dtype: torch.dtype, device=None):
        super().__init__()
        self.encoder = mlp([4] + list(layers) + [feature_dim], dtype=dtype,
                           device=device)

    def forward(self, kpts: torch.Tensor, scores: torch.Tensor,
                valid_mask: Optional[torch.Tensor] = None):
        return apply_mlp(self.encoder,
                         torch.cat([kpts, scores[..., None]], dim=-1),
                         valid_mask)

    def reset_parameters(self, generator: torch.Generator):
        reset_mlp(self.encoder, generator, zero_last_bias=True)


class DescriptorEncoder(nn.Module):
    """MLP([33, *layers, D]) over FPFH descriptors."""

    def __init__(self, feature_dim: int, layers: Sequence[int], *,
                 dtype: torch.dtype, device=None, in_dim: int = 33):
        super().__init__()
        self.encoder = mlp([in_dim] + list(layers) + [feature_dim],
                           dtype=dtype, device=device)

    def forward(self, desc: torch.Tensor,
                valid_mask: Optional[torch.Tensor] = None):
        return apply_mlp(self.encoder, desc, valid_mask)

    def reset_parameters(self, generator: torch.Generator):
        reset_mlp(self.encoder, generator, zero_last_bias=True)


def global_context_concat(y: torch.Tensor,
                          valid_mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """``cat(y, max over the valid points of y)`` [B, N, 2D]: the global
    context of ``DescriptorGloabalEncoder`` and ``pointnetDescriptorEncoder``
    (``models/superglue.py:199-219``); padded points read as -1e30."""
    masked = y if valid_mask is None else torch.where(
        valid_mask[..., None], y, -1e30)
    glob = masked.amax(dim=-2, keepdim=True).expand_as(y)
    return torch.cat([y, glob], dim=-1)


class DescriptorGlobalEncoder(nn.Module):
    """``FPFH_gloabal`` (sic): MLP([33, *layers, D]), the global max-pool
    concat, then MLP([2D, 2D, D]) (``models/mdgat.py:156-174``), both with a
    zero final bias."""

    def __init__(self, feature_dim: int, layers: Sequence[int], *,
                 dtype: torch.dtype, device=None, in_dim: int = 33):
        super().__init__()
        self.encoder = mlp([in_dim] + list(layers) + [feature_dim],
                           dtype=dtype, device=device)
        self.encoder2 = mlp([feature_dim * 2, feature_dim * 2, feature_dim],
                            dtype=dtype, device=device)

    def forward(self, desc: torch.Tensor,
                valid_mask: Optional[torch.Tensor] = None):
        y = apply_mlp(self.encoder, desc, valid_mask)
        return apply_mlp(self.encoder2, global_context_concat(y, valid_mask),
                         valid_mask)

    def reset_parameters(self, generator: torch.Generator):
        reset_mlp(self.encoder, generator, zero_last_bias=True)
        reset_mlp(self.encoder2, generator, zero_last_bias=True)


class PointnetDescriptorEncoder(nn.Module):
    """SuperGlue's ``pointnetDescriptorEncoder``: MLP([2D, 2D, D]) over
    ``cat(desc, global max-pool)``, zero final bias. The reference builds it
    for the pointnet modes and never calls it (``superglue.py:346-360,
    421-424``); it is here so that their checkpoints load."""

    def __init__(self, feature_dim: int, *, dtype: torch.dtype, device=None):
        super().__init__()
        self.encoder = mlp([feature_dim * 2, feature_dim * 2, feature_dim],
                           dtype=dtype, device=device)

    def forward(self, desc: torch.Tensor,
                valid_mask: Optional[torch.Tensor] = None):
        return apply_mlp(self.encoder, global_context_concat(desc, valid_mask),
                         valid_mask)

    def reset_parameters(self, generator: torch.Generator):
        reset_mlp(self.encoder, generator, zero_last_bias=True)
