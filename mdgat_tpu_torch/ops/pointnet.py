"""PointNet++ grouping and set abstraction in plain PyTorch.

Port of ``mdgat_tpu/ops/pointnet.py`` (reference ``models/pointnet/
pointnet_util.py``). The radius query is a top-k over index keys (no sort of
the whole row), gathers clamp the index and zero the rows of the sentinel
(the reference's appended zero row, ``pointnet_util.py:70-73``), and FPS is
a loop of ``npoint`` steps.

Semantics kept exactly, as in the JAX package:

* ``ball_query`` (``query_ball_point``, ``pointnet_util.py:101-121``): per
  center the ``nsample`` lowest-index points with ``d2 <= radius**2``, in
  ascending order; a short ball backfills with its first index; an empty
  ball keeps the ``N`` sentinel. ``d2`` is :func:`~mdgat_tpu_torch.ops.
  geometry.pairwise_dist2`'s matmul expansion in the inputs' dtype, so a
  point within rounding of the sphere may fall either way on another
  device or dtype.
* ``gather_zero_sentinel``: ``idx == N`` gathers a zero row, so an empty
  ball's relative coordinates are ``-center`` and its features 0.
* grouped order ``[features, rel_xyz]`` in the keypoint-centred path
  (``pointnet_util.py:331``), ``[rel_xyz, features]`` in the FPS paths
  (``pointnet_util.py:151``).
* FPS starts every distance at ``1e10`` and puts ``-1`` on masked points,
  so a padded point is never picked; ties go to the first index.

The conv stacks are the modules of :func:`~mdgat_tpu_torch.ops.mlp.
conv_bn_stack` (a ``(convs, bns)`` pair each), and their ``training`` flag
chooses batch or running BN statistics, where the JAX functions take
``train``. Indices are int64, torch's index dtype. Max-pools over a group
are ``amax``, whose gradient splits evenly between equal entries, as JAX's
``max`` does (backfilled balls repeat a row).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from mdgat_tpu_torch.ops.geometry import pairwise_dist2
from mdgat_tpu_torch.ops.mlp import apply_conv_bn_stack

Stack = Tuple[nn.ModuleList, nn.ModuleList]


def ball_query(xyz: torch.Tensor, centers: torch.Tensor, radius: float,
               nsample: int) -> torch.Tensor:
    """Radius-grouping indices [B, S, nsample] of ``xyz`` [B, N, 3] around
    ``centers`` [B, S, 3], ``N`` marking an empty ball. The ``nsample``
    smallest keys ``where(in radius, idx, N)`` are the ``nsample`` largest
    of ``N - key``: one ``topk`` over distinct keys, in the JAX order."""
    n = xyz.shape[1]
    d2 = pairwise_dist2(centers, xyz)                          # [B, S, N]
    rev = torch.arange(n, 0, -1, dtype=torch.int32, device=xyz.device)
    top = torch.where(d2 <= radius ** 2, rev, 0).topk(nsample, dim=-1).values
    group_idx = n - top.long()                                 # ascending
    return torch.where(group_idx == n, group_idx[..., :1], group_idx)


def gather_zero_sentinel(points: torch.Tensor,
                         idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``points`` [B, N, C] at ``idx`` [B, ...]; ``idx == N`` gives
    a zero row (``index_points``, ``pointnet_util.py:43-74``)."""
    b, n, c = points.shape
    flat = idx.clamp_max(n - 1).reshape(b, -1, 1).expand(-1, -1, c)
    g = torch.gather(points, 1, flat).reshape(*idx.shape, c)
    return g * (idx < n)[..., None].to(points.dtype)


def farthest_point_sample(xyz: torch.Tensor, npoint: int,
                          start: Optional[torch.Tensor] = None,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Iterative FPS (``pointnet_util.py:77-98``): [B, npoint] indices from
    ``start`` [B] (0 when None; the reference draws it at random) over the
    points ``mask`` [B, N] marks (all when None)."""
    b, n, _ = xyz.shape
    distance = torch.full((b, n), 1e10, dtype=xyz.dtype, device=xyz.device)
    if mask is not None:
        distance = torch.where(mask, distance, -1.0)
    farthest = (torch.zeros(b, dtype=torch.long, device=xyz.device)
                if start is None else start.long())
    rows = torch.arange(b, device=xyz.device)
    centroids = torch.empty((b, npoint), dtype=torch.long, device=xyz.device)
    for i in range(npoint):
        centroids[:, i] = farthest
        d = ((xyz - xyz[rows, farthest][:, None, :]) ** 2).sum(dim=-1)
        distance = torch.where(d < distance, d, distance)
        farthest = distance.argmax(dim=-1)
    return centroids


def _group_pool(stack: Stack, xyz, features, centers, radius, nsample,
                features_first: bool) -> torch.Tensor:
    """One scale: ball around each center, relative xyz and features in
    the path's order, the conv stack, max over the group -> [B, S, C']."""
    idx = ball_query(xyz, centers, radius, nsample)
    gx = gather_zero_sentinel(xyz, idx) - centers[:, :, None, :]
    if features is not None:
        gf = gather_zero_sentinel(features, idx)
        gx = torch.cat([gf, gx] if features_first else [gx, gf], dim=-1)
    return apply_conv_bn_stack(*stack, gx).amax(dim=2)


def _fps_centers(xyz, npoint, fps_start):
    idx = farthest_point_sample(xyz, npoint, fps_start)
    return torch.gather(xyz, 1, idx[..., None].expand(-1, -1, 3))


def set_kpts_msg(stacks: Sequence[Stack], xyz: torch.Tensor,
                 features: Optional[torch.Tensor], kpts: torch.Tensor,
                 radius_list: Sequence[float],
                 nsample_list: Sequence[int]) -> torch.Tensor:
    """``PointNetSetKptsMsg`` (``pointnet_util.py:284-346``): multi-scale
    grouping centred at the keypoints. ``xyz`` [B, N, 3], ``features``
    [B, N, D] or None, ``kpts`` [B, S, 3]; one stack a scale. Returns
    [B, S, sum of the stacks' last widths]."""
    return torch.cat([
        _group_pool(stack, xyz, features, kpts, radius, nsample, True)
        for stack, radius, nsample in zip(stacks, radius_list, nsample_list)],
        dim=-1)


def set_abstraction_all(stack: Stack, xyz: torch.Tensor,
                        features: Optional[torch.Tensor]) -> torch.Tensor:
    """``PointNetSetAbstraction(group_all=True)`` as shipped: a pointwise
    stack over ``cat(xyz, features)``, no pool (the reference's max-pool is
    commented out, ``pointnet_util.py:219``). [B, S, 3] and [B, S, D] ->
    [B, S, D']."""
    h = xyz if features is None else torch.cat([xyz, features], dim=-1)
    return apply_conv_bn_stack(*stack, h)


def set_abstraction_msg(stacks: Sequence[Stack], xyz: torch.Tensor,
                        features: Optional[torch.Tensor], npoint: int,
                        radius_list: Sequence[float],
                        nsample_list: Sequence[int],
                        fps_start: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``PointNetSetAbstractionMsg`` (``pointnet_util.py:224-282``): FPS
    centers, multi-scale ball grouping ``[rel_xyz, features]``, a stack and
    a max-pool a scale, scales concatenated. Returns (centers [B, S, 3],
    features [B, S, sum of widths])."""
    centers = _fps_centers(xyz, npoint, fps_start)
    return centers, torch.cat([
        _group_pool(stack, xyz, features, centers, radius, nsample, False)
        for stack, radius, nsample in zip(stacks, radius_list, nsample_list)],
        dim=-1)


def feature_propagation(stack: Stack, xyz1: torch.Tensor, xyz2: torch.Tensor,
                        points1: Optional[torch.Tensor],
                        points2: torch.Tensor) -> torch.Tensor:
    """``PointNetFeaturePropagation`` (``pointnet_util.py:349-399``):
    ``points2`` (at ``xyz2`` [B, S, 3]) interpolated onto ``xyz1`` [B, N, 3]
    by inverse squared distance over the 3 nearest, concatenated after
    ``points1`` when given, then the stack."""
    b, n, _ = xyz1.shape
    if xyz2.shape[1] == 1:
        interp = points2.expand(b, n, points2.shape[-1])
    else:
        negd, idx = torch.topk(-pairwise_dist2(xyz1, xyz2), 3, dim=-1)
        recip = 1.0 / (-negd + 1e-8)
        w = recip / recip.sum(dim=-1, keepdim=True)             # [B, N, 3]
        interp = (gather_zero_sentinel(points2, idx) * w[..., None]).sum(2)
    h = interp if points1 is None else torch.cat([points1, interp], dim=-1)
    return apply_conv_bn_stack(*stack, h)


def sample_and_group(stack: Stack, xyz: torch.Tensor,
                     features: Optional[torch.Tensor], npoint: int,
                     radius: float, nsample: int,
                     fps_start: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FPS-centred single-scale abstraction (``sample_and_group`` + the
    stack, ``pointnet_util.py:124-157``) with a max-pool over the group.
    Returns (centers [B, npoint, 3], features [B, npoint, C'])."""
    centers = _fps_centers(xyz, npoint, fps_start)
    return centers, _group_pool(stack, xyz, features, centers, radius,
                                nsample, False)
