"""Geometry in plain PyTorch: ground-truth correspondences and the pose fit.

Port of ``mdgat_tpu/ops/geometry.py``:

* ``pairwise_dist2`` and ``gt_correspondences`` (reference
  ``load_data.py:257-285``): nearest neighbour in the world frame under a
  distance threshold, batched on the device, with masks for fixed-shape
  padding;
* the pose half (reference ``utils/utils_test.py:41-110``):
  ``transform_points``, the one-step SVD fit ``kabsch`` (no reflection fix,
  as the reference) and ``kabsch_proper`` (with it), the registration
  errors RTE / RRE and the inlier count.

Every function is batched over leading axes and runs on any device in the
dtype of its inputs; ``torch.linalg.svd`` / ``inv`` / ``det`` are library
calls, off any kernel's path (the JAX package computes them outside Pallas
too). The eval CLIs fit poses on the host in numpy instead
(``eval/metrics.py``), as the JAX package's do.
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


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply 4x4 rigid transforms [..., 4, 4] to points [..., N, 3]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return torch.matmul(pts, R.transpose(-1, -2)) + t[..., None, :]


def _centred_cov(P, Q, weights, weight_q: bool):
    """Centroids up, uq [..., 1, 3] and the covariance H = (Q-uq)^T (P-up)
    [..., 3, 3]; with ``weights`` the weighted centroids, the weight on the
    P side (``kabsch``) or on the Q side (``kabsch_proper``), as the JAX
    package forms them."""
    if weights is None:
        up = P.mean(dim=-2, keepdim=True)
        uq = Q.mean(dim=-2, keepdim=True)
        Pc, Qc = P - up, Q - uq
    else:
        w = weights[..., None].to(P.dtype)
        s = w.sum(dim=-2, keepdim=True).clamp_min(1e-12)
        up = (P * w).sum(dim=-2, keepdim=True) / s
        uq = (Q * w).sum(dim=-2, keepdim=True) / s
        if weight_q:
            Pc, Qc = P - up, (Q - uq) * w
        else:
            Pc, Qc = (P - up) * w, Q - uq
    return up, uq, torch.matmul(Qc.transpose(-1, -2), Pc)


def _rigid(R, up, uq):
    """[..., 4, 4] transform of rotation R with t = uq - R up."""
    t = uq[..., 0, :] - torch.einsum("...ij,...j->...i", R, up[..., 0, :])
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def kabsch(P: torch.Tensor, Q: torch.Tensor,
           weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-step SVD rigid fit mapping P -> Q (``solve_icp``,
    ``utils/utils_test.py:73-110``): P, Q [..., N, 3], optional ``weights``
    [..., N] (0 = ignore a point). Like the reference, R = U Vh without the
    reflection fix (:func:`kabsch_proper` has it). Returns [..., 4, 4]."""
    up, uq, H = _centred_cov(P, Q, weights, weight_q=False)
    U, _, Vh = torch.linalg.svd(H, full_matrices=True)
    return _rigid(torch.matmul(U, Vh), up, uq)


def kabsch_proper(P: torch.Tensor, Q: torch.Tensor,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`kabsch` with the det(R) reflection fix: where the plain fit's
    det(R) < 0 the rotation is solved again with the last singular vector
    flipped, so R is a proper rotation."""
    R0 = kabsch(P, Q, weights)[..., :3, :3]
    flip = torch.where(torch.linalg.det(R0) < 0, -1.0, 1.0).to(P.dtype)
    up, uq, H = _centred_cov(P, Q, weights, weight_q=True)
    U, _, Vh = torch.linalg.svd(H, full_matrices=True)
    D = torch.ones(U.shape[:-1], dtype=U.dtype, device=U.device)
    D[..., -1] = flip
    return _rigid(torch.matmul(U * D[..., None, :], Vh), up, uq)


def registration_errors(T: torch.Tensor, T_gt: torch.Tensor,
                        clamp_arccos: bool = False):
    """RTE / RRE of ``calculate_error`` (``utils/utils_test.py:41-71``):
    ``T_err = T^-1 @ T_gt``, RTE = |t|, RRE = arccos((tr(R) - 1) / 2). The
    reference does not clamp the arccos argument (NaN past +-1);
    ``clamp_arccos=True`` clamps it to [-1, 1]. Returns (rte, rre) [...]."""
    T_err = torch.matmul(torch.linalg.inv(T), T_gt)
    rte = torch.linalg.vector_norm(T_err[..., :3, 3], dim=-1)
    f_theta = (T_err[..., 0, 0] + T_err[..., 1, 1] + T_err[..., 2, 2]
               - 1.0) / 2
    if clamp_arccos:
        f_theta = f_theta.clamp(-1.0, 1.0)
    return rte, torch.arccos(f_theta)


def inlier_count(T: torch.Tensor, mkpts0: torch.Tensor, mkpts1: torch.Tensor,
                 radius: float = 1.0,
                 weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Matched points of cloud 1 moved by T that land within ``radius`` of
    their match in cloud 0 (``utils/utils_test.py:55-63``); with
    ``weights`` only points of weight > 0 count. Returns int64 [...]."""
    d = torch.linalg.vector_norm(transform_points(T, mkpts1) - mkpts0, dim=-1)
    ok = d < radius
    if weights is not None:
        ok = ok & (weights > 0)
    return ok.sum(dim=-1)
