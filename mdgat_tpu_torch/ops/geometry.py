"""Pose-based ground-truth correspondences, plain PyTorch.

Port of ``pairwise_dist2`` and ``gt_correspondences`` of
``mdgat_tpu/ops/geometry.py`` (reference ``load_data.py:257-285``): nearest
neighbour in the world frame under a distance threshold, batched on the
device, with masks for fixed-shape padding. The pose fit and the error
metrics of that module are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


def pairwise_dist2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances [..., N, M] between a [..., N, 3] and
    b [..., M, 3] by the expansion |a|^2 - 2ab + |b|^2, clamped at 0
    against cancellation."""
    a2 = (a * a).sum(dim=-1, keepdim=True)
    b2 = (b * b).sum(dim=-1, keepdim=True)
    inner = torch.matmul(a, b.transpose(-1, -2))
    return (a2 - 2.0 * inner + b2.transpose(-1, -2)).clamp_min(0.0)


class GTMatches(NamedTuple):
    matches0: torch.Tensor  # [..., N] int32, -1 = unmatched
    matches1: torch.Tensor  # [..., M] int32
    rep: torch.Tensor       # [...] int32: rows with a neighbour under tau


def gt_correspondences(kpts0_w, kpts1_w, threshold: float,
                       mutual_check: bool = False,
                       mask0: Optional[torch.Tensor] = None,
                       mask1: Optional[torch.Tensor] = None) -> GTMatches:
    """Ground-truth matches of world-frame keypoints [..., N, 3] and
    [..., M, 3] (``load_data.py:257-285``): each point's nearest neighbour
    in the other cloud if closer than ``threshold``; with ``mutual_check``
    the reference's ``intersect1d`` rule. Masks mark valid points."""
    d2 = pairwise_dist2(kpts0_w, kpts1_w)
    if mask0 is not None:
        d2 = torch.where(mask0[..., :, None], d2, 1e30)
    if mask1 is not None:
        d2 = torch.where(mask1[..., None, :], d2, 1e30)
    t2 = float(threshold) ** 2
    v0, nn0 = d2.min(dim=-1)          # nearest kp1 of each kp0
    v1, nn1 = d2.min(dim=-2)          # nearest kp0 of each kp1
    ok0, ok1 = v0 < t2, v1 < t2
    n, m = nn0.shape[-1], nn1.shape[-1]

    if mutual_check:
        # load_data.py:274-279: kp1 indices j that are mutual nearest
        # neighbours (nn0[nn1[j]] == j) and are the neighbour of some
        # thresholded kp0
        jm = torch.arange(m, device=d2.device)
        mutual_j = torch.gather(nn0, -1, nn1) == jm
        in_f = (ok0[..., :, None] & (nn0[..., :, None] == jm)).any(dim=-2)
        sel = mutual_j & in_f
        matches1 = torch.where(sel, nn1, -1)
        # scatter to the kp0 side: matches0[nn1[j]] = j for selected j
        # (slot n takes the unselected ones and is dropped)
        rows = torch.where(sel, nn1, n)
        out = torch.full(nn0.shape[:-1] + (n + 1,), -1, dtype=torch.int64,
                         device=d2.device)
        out.scatter_(-1, rows, torch.where(sel, jm.expand(nn1.shape), -1))
        matches0 = out[..., :n]
    else:
        matches0 = torch.where(ok0, nn0, -1)
        matches1 = torch.where(ok1, nn1, -1)

    rep = ok0.sum(dim=-1).to(torch.int32)
    if mask0 is not None:
        matches0 = torch.where(mask0, matches0, -1)
    if mask1 is not None:
        matches1 = torch.where(mask1, matches1, -1)
    return GTMatches(matches0.to(torch.int32), matches1.to(torch.int32), rep)
