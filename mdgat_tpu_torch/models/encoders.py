"""Keypoint and FPFH descriptor encoders (``models/mdgat.py:144-188``).

Port of the FPFH arm of ``mdgat_tpu/models/encoders.py``: point-wise MLPs
over ``[B, N, C]`` with the reference's zero-initialised final bias.
Module and attribute names (``encoder``) follow the reference so the
state-dict keys are ``kenc.encoder.*`` / ``denc.encoder.*``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from mdgat_tpu_torch.ops.mlp import mlp, reset_mlp


class KeypointEncoder(nn.Module):
    """MLP([4, *layers, D]) over ``cat(xyz, score)``."""

    def __init__(self, feature_dim: int, layers: Sequence[int], *,
                 dtype: torch.dtype, device=None):
        super().__init__()
        self.encoder = mlp([4] + list(layers) + [feature_dim], dtype=dtype,
                           device=device)

    def forward(self, kpts: torch.Tensor, scores: torch.Tensor):
        return self.encoder(torch.cat([kpts, scores[..., None]], dim=-1))

    def reset_parameters(self, generator: torch.Generator):
        reset_mlp(self.encoder, generator, zero_last_bias=True)


class DescriptorEncoder(nn.Module):
    """MLP([33, *layers, D]) over FPFH descriptors."""

    def __init__(self, feature_dim: int, layers: Sequence[int], *,
                 dtype: torch.dtype, device=None, in_dim: int = 33):
        super().__init__()
        self.encoder = mlp([in_dim] + list(layers) + [feature_dim],
                           dtype=dtype, device=device)

    def forward(self, desc: torch.Tensor):
        return self.encoder(desc)

    def reset_parameters(self, generator: torch.Generator):
        reset_mlp(self.encoder, generator, zero_last_bias=True)
