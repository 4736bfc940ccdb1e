"""Learned descriptors from raw clouds: ``PointnetEncoder`` and
``PointnetEncoderMsg`` (reference ``models/mdgat.py:53-143``).

Port of ``mdgat_tpu/models/pointnet_encoder.py``. Per cloud: multi-scale
keypoint-centred grouping (``sa1``, ``PointNetSetKptsMsg``), a pointwise set
abstraction over ``[kpts_xyz, pooled features]`` (``sa2``, no pool), then
``cat(KeypointEncoder(kpts, scores), sa2)`` through MLP([2D, 2D, D]).
SuperGlue's variant (``models/superglue.py:108-153``) has neither ``kenc``
nor ``mlp``: the ``sa2`` features are the descriptors.

A raw cloud is ``[B, Np, 8]``: xyz, then the 5 channels the reference calls
normals (``in_channel=5``, ``models/mdgat.py:73-78``).

The encoder takes no validity mask, as in the JAX package and the
reference: in training mode every keypoint slot, padded ones included,
enters the BatchNorm statistics of ``sa1``, ``sa2``, ``kenc`` and ``mlp``.

State-dict keys are the reference's: ``penc.sa1.conv_blocks.{i}.{j}``,
``penc.sa1.bn_blocks.{i}.{j}``, ``penc.sa2.mlp_convs.{j}``,
``penc.sa2.mlp_bns.{j}``, ``penc.kenc.encoder.*``, ``penc.mlp.*``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from mdgat_tpu_torch.models.encoders import KeypointEncoder
from mdgat_tpu_torch.ops.mlp import apply_mlp, conv_bn_stack, mlp, reset_mlp
from mdgat_tpu_torch.ops.pointnet import set_abstraction_all, set_kpts_msg

# the reference's hyperparameters (models/mdgat.py:59-60, :104-106)
SSG_SPEC = {"radius_list": (2.0,), "nsample_list": (32,),
            "mlps": ((64, 64, 128),), "in_channel": 5}
# SuperGlue's own single-scale variant uses radius 1 (superglue.py:113)
SG_SSG_SPEC = {"radius_list": (1.0,), "nsample_list": (32,),
               "mlps": ((64, 64, 128),), "in_channel": 5}
MSG_SPEC = {"radius_list": (1.0, 1.5, 2.25), "nsample_list": (16, 32, 128),
            "mlps": ((32, 32, 64), (64, 64, 128), (64, 96, 128)),
            "in_channel": 5}


def encoder_spec(msg: bool, superglue: bool = False):
    if msg:
        return MSG_SPEC          # the same in both nets (superglue.py:71)
    return SG_SSG_SPEC if superglue else SSG_SPEC


class PointNetSetKptsMsg(nn.Module):
    """``sa1``: one ``Conv2d`` + ``BatchNorm2d`` stack a scale."""

    def __init__(self, spec, *, dtype: torch.dtype, device=None):
        super().__init__()
        self.radius_list = tuple(spec["radius_list"])
        self.nsample_list = tuple(spec["nsample_list"])
        stacks = [conv_bn_stack([spec["in_channel"] + 3] + list(widths),
                                dtype=dtype, device=device)
                  for widths in spec["mlps"]]
        self.conv_blocks = nn.ModuleList([c for c, _ in stacks])
        self.bn_blocks = nn.ModuleList([b for _, b in stacks])

    def forward(self, xyz, features, kpts):
        return set_kpts_msg(list(zip(self.conv_blocks, self.bn_blocks)),
                            xyz, features, kpts, self.radius_list,
                            self.nsample_list)


class PointNetSetAbstraction(nn.Module):
    """``sa2``: the pointwise ``group_all`` abstraction as shipped."""

    def __init__(self, channels: Sequence[int], *, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.mlp_convs, self.mlp_bns = conv_bn_stack(channels, dtype=dtype,
                                                     device=device)

    def forward(self, xyz, features):
        return set_abstraction_all((self.mlp_convs, self.mlp_bns), xyz,
                                   features)


class PointnetEncoder(nn.Module):
    """``cloud`` [B, Np, 8], ``kpts`` [B, S, 3], ``scores`` [B, S] ->
    descriptors [B, S, D]. ``msg`` selects the multi-scale spec;
    ``superglue`` the variant without ``kenc`` and ``mlp``."""

    def __init__(self, feature_dim: int, kenc_layers: Sequence[int], *,
                 msg: bool, superglue: bool, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.spec = encoder_spec(msg, superglue)
        self.superglue = superglue
        kw = dict(dtype=dtype, device=device)
        self.sa1 = PointNetSetKptsMsg(self.spec, **kw)
        scale_out = sum(widths[-1] for widths in self.spec["mlps"])
        self.sa2 = PointNetSetAbstraction(
            [scale_out + 3, 256, 256, feature_dim], **kw)
        if not superglue:
            self.mlp = mlp([feature_dim * 2, feature_dim * 2, feature_dim],
                           **kw)
            self.kenc = KeypointEncoder(feature_dim, kenc_layers, **kw)

    def forward(self, cloud: torch.Tensor, kpts: torch.Tensor,
                scores: torch.Tensor) -> torch.Tensor:
        xyz = cloud[..., :3]
        feats = cloud[..., 3:3 + self.spec["in_channel"]]
        desc = self.sa2(kpts, self.sa1(xyz, feats, kpts))
        if self.superglue:
            return desc
        return apply_mlp(self.mlp, torch.cat([self.kenc(kpts, scores), desc],
                                             dim=-1))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """``Conv2d`` / ``Conv1d`` defaults; the keypoint encoder's final
        bias zero, as everywhere."""
        for convs in list(self.sa1.conv_blocks) + [self.sa2.mlp_convs]:
            for conv in convs:
                conv.reset_parameters(generator)
        if not self.superglue:
            reset_mlp(self.mlp, generator)
            self.kenc.reset_parameters(generator)
