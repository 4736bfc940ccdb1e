"""Matching losses on the decomposed OT scores, plain PyTorch.

Port of ``mdgat_tpu/ops/losses.py`` (reference ``models/mdgat.py:486-594``):
the gap loss (the paper's), the hard-negative triplet loss and SuperGlue's
NLL. Each returns a per-example ``[B]`` vector and never mutates the
ground truth (``-1`` = unmatched, remapped to the dustbin internally).
This slice runs them in the eval forward when ground truth is given; their
kernels and gradients come with the training slice.
"""

from __future__ import annotations

import torch

from mdgat_tpu_torch.ops.transport import BIG_NEG, OTScores


def _masks(b, n, m, row_mask, col_mask, device):
    rm = (row_mask if row_mask is not None
          else torch.ones((b, n), dtype=torch.bool, device=device))
    cm = (col_mask if col_mask is not None
          else torch.ones((b, m), dtype=torch.bool, device=device))
    return rm, cm


def _mean_over(x, mask):
    mask = mask.to(x.dtype)
    return (x * mask).sum(dim=1) / mask.sum(dim=1).clamp_min(1)


def gap_loss(ot: OTScores, gt0, gt1, gamma: float, row_mask=None,
             col_mask=None):
    """Gap loss (``models/mdgat.py:547-594``): per anchor with GT index p
    (the dustbin if unmatched), ``2 log(1 + sum relu(s_neg - s_pos +
    gamma))`` over every other candidate including the dustbin, averaged
    over anchors, in both directions, averaged."""
    dense, bin_row, bin_col = ot.dense, ot.bin_row, ot.bin_col
    b, n, m = dense.shape
    dt, dev = dense.dtype, dense.device
    rm, cm = _masks(b, n, m, row_mask, col_mask, dev)

    dense0 = torch.where(cm[:, None, :], dense, BIG_NEG)
    pos_idx0 = torch.where(gt0 < 0, m, gt0)
    is_pos0 = torch.arange(m, device=dev)[None, None, :] == pos_idx0[:, :, None]
    pos_main0 = torch.where(is_pos0, dense0, 0.0).sum(dim=2)
    at_bin0 = pos_idx0 == m
    pos0 = torch.where(at_bin0, bin_col, pos_main0)[:, :, None]
    contrib0 = torch.relu(dense0 - pos0 + gamma) * (~is_pos0).to(dt)
    bin_term0 = torch.relu(bin_col - pos0[:, :, 0] + gamma) * (~at_bin0).to(dt)
    loss0 = _mean_over(2.0 * torch.log1p(contrib0.sum(dim=2) + bin_term0), rm)

    dense1 = torch.where(rm[:, :, None], dense, BIG_NEG)
    pos_idx1 = torch.where(gt1 < 0, n, gt1)
    is_pos1 = torch.arange(n, device=dev)[None, :, None] == pos_idx1[:, None, :]
    pos_main1 = torch.where(is_pos1, dense1, 0.0).sum(dim=1)
    at_bin1 = pos_idx1 == n
    pos1 = torch.where(at_bin1, bin_row, pos_main1)[:, None, :]
    contrib1 = torch.relu(dense1 - pos1 + gamma) * (~is_pos1).to(dt)
    bin_term1 = torch.relu(bin_row - pos1[:, 0, :] + gamma) * (~at_bin1).to(dt)
    loss1 = _mean_over(2.0 * torch.log1p(contrib1.sum(dim=1) + bin_term1), cm)
    return (loss0 + loss1) / 2.0


def triplet_loss(ot: OTScores, gt0, gt1, gamma: float, row_mask=None,
                 col_mask=None):
    """Hard-negative triplet loss (``models/mdgat.py:512-546``): the hard
    negative is the best candidate, or the second best when the best is
    the ground truth."""
    dense, bin_row, bin_col = ot.dense, ot.bin_row, ot.bin_col
    b, n, m = dense.shape
    dt, dev = dense.dtype, dense.device
    rm, cm = _masks(b, n, m, row_mask, col_mask, dev)

    def one_direction(slab, pos_idx, anchor_mask):
        top2_v, top2_i = torch.topk(slab, 2, dim=2)
        best_is_gt = top2_i[..., 0] == pos_idx
        neg_score = torch.where(best_is_gt, top2_v[..., 1], top2_v[..., 0])
        pos_score = torch.gather(slab, 2, pos_idx[:, :, None])[..., 0]
        per_anchor = torch.relu(neg_score - pos_score + gamma)
        am = anchor_mask.to(dt)
        return (per_anchor * am).sum(dim=1), am.sum(dim=1)

    slab0 = torch.cat([torch.where(cm[:, None, :], dense, BIG_NEG),
                       bin_col[:, :, None]], dim=2)
    s0, c0 = one_direction(slab0, torch.where(gt0 < 0, m, gt0).long(), rm)
    slab1 = torch.cat([torch.where(rm[:, :, None], dense, BIG_NEG),
                       bin_row[:, None, :]], dim=1).transpose(1, 2)
    s1, c1 = one_direction(slab1, torch.where(gt1 < 0, n, gt1).long(), cm)
    return (s0 + s1) / (c0 + c1).clamp_min(1)


def superglue_nll_loss(ot: OTScores, gt0, gt1, row_mask=None, col_mask=None):
    """SuperGlue NLL (``models/mdgat.py:487-511``), normalised by
    (#unmatched cols + M) per example."""
    dense, bin_row, bin_col = ot.dense, ot.bin_row, ot.bin_col
    b, n, m = dense.shape
    dt = dense.dtype
    rm, cm = _masks(b, n, m, row_mask, col_mask, dense.device)
    slab0 = torch.cat([dense, bin_col[:, :, None]], dim=2)
    pos_idx0 = torch.where(gt0 < 0, m, gt0).long()
    tp = torch.gather(slab0, 2, pos_idx0[:, :, None])[..., 0]
    loss_tp = (tp * rm.to(dt)).sum(dim=1)
    unmatched = (gt1 < 0) & cm
    loss_tn = (bin_row * unmatched.to(dt)).sum(dim=1)
    xx = unmatched.sum(dim=1).to(dt)
    m_true = cm.sum(dim=1).to(dt)
    return (-loss_tp - loss_tn) / (xx + m_true)
