"""Match decision: OT scores -> match indices.

Port of ``mdgat_tpu/ops/matching.py`` (reference ``models/mdgat.py:
442-483``), selected by ``loss_method``:

* ``'superglue'``: argmax over the dense block only, thresholded on
  ``exp(score) > match_threshold``;
* gap/triplet (default): argmax including the dustbin; a keypoint is
  unmatched iff its argmax is the dustbin. Dense wins ties with the dustbin
  (``>=``: torch.max returns the first maximal index).

Padded keypoints (masks False) always yield -1. The reference's quirk is
kept: when no keypoint of the whole batch has a valid match, every score
is zeroed.

:func:`filter_matches` is LightGlue's decision (``models/lightglue.py``,
upstream ``lightglue.py::filter_matches``) over its assignment's inner
block, which has no dustbin competing.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import math

import torch

from mdgat_tpu_torch.ops.transport import BIG_NEG, OTScores


class MatchResult(NamedTuple):
    matches0: torch.Tensor          # [B, N] int32, -1 = unmatched
    matches1: torch.Tensor          # [B, M] int32
    matching_scores0: torch.Tensor  # [B, N]
    matching_scores1: torch.Tensor  # [B, M]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, 1, idx.long())


def match_decision(ot: OTScores, loss_method: str, match_threshold: float,
                   mutual_check: bool,
                   row_mask: Optional[torch.Tensor] = None,
                   col_mask: Optional[torch.Tensor] = None) -> MatchResult:
    dense, bin_row, bin_col = ot.dense, ot.bin_row, ot.bin_col
    b, n, m = dense.shape
    dev = dense.device
    rm = (row_mask if row_mask is not None
          else torch.ones((b, n), dtype=torch.bool, device=dev))
    cm = (col_mask if col_mask is not None
          else torch.ones((b, m), dtype=torch.bool, device=dev))
    if row_mask is not None or col_mask is not None:
        dense = torch.where(rm[:, :, None] & cm[:, None, :], dense, BIG_NEG)
        bin_col = torch.where(rm, bin_col, BIG_NEG)
        bin_row = torch.where(cm, bin_row, BIG_NEG)

    max0v, idx0 = dense.max(dim=2)      # first maximal index on ties
    max1v, idx1 = dense.max(dim=1)
    idx0, idx1 = idx0.to(torch.int32), idx1.to(torch.int32)
    arange_n = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
    arange_m = torch.arange(m, dtype=torch.int32, device=dev)[None, :]

    if loss_method == "superglue":
        if mutual_check:
            mutual0 = arange_n == _take(idx1, idx0)
            mutual1 = arange_m == _take(idx0, idx1)
            mscores0 = torch.where(mutual0, torch.exp(max0v), 0.0)
            mscores1 = torch.where(mutual1, _take(mscores0, idx1), 0.0)
            valid0 = mutual0 & (mscores0 > match_threshold)
            valid1 = mutual1 & _take(valid0, idx1)
        else:
            valid0 = torch.exp(max0v) > match_threshold
            valid1 = torch.exp(max1v) > match_threshold
            mscores0 = torch.where(valid0, torch.exp(max0v), 0.0)
            mscores1 = torch.where(valid1, torch.exp(max1v), 0.0)
    else:
        valid0 = max0v >= bin_col
        valid1 = max1v >= bin_row
        full_max0 = torch.maximum(max0v, bin_col)
        full_max1 = torch.maximum(max1v, bin_row)
        if mutual_check:
            keep0 = valid0 & (arange_n == _take(idx1, idx0))
            keep1 = valid1 & (arange_m == _take(idx0, idx1))
        else:
            keep0, keep1 = valid0, valid1
        mscores0 = torch.where(keep0, torch.exp(full_max0), 0.0)
        mscores1 = torch.where(keep1, torch.exp(full_max1), 0.0)
        # reference quirk: no valid match in the whole batch zeroes scores
        any_valid = valid0.any()
        mscores0 = torch.where(any_valid, mscores0, 0.0)
        mscores1 = torch.where(any_valid, mscores1, 0.0)

    valid0 = valid0 & rm
    valid1 = valid1 & cm
    return MatchResult(torch.where(valid0, idx0, -1),
                       torch.where(valid1, idx1, -1),
                       torch.where(rm, mscores0, 0.0),
                       torch.where(cm, mscores1, 0.0))


def filter_matches(inner: torch.Tensor, th: float, mask0: torch.Tensor,
                   mask1: torch.Tensor):
    """Upstream LightGlue's ``filter_matches`` over the valid block of the
    inner assignment ``inner`` [B, N, M]: a mutual argmax (the first
    maximal index wins a tie), a match where ``exp(score) > th``;
    (matches0, matches1 with -1 unmatched, mscores0, mscores1), ``mscores``
    the exponential of a mutual row's best also where it is under ``th``,
    padded rows and columns unmatched with score 0."""
    valid = mask0[:, :, None] & mask1[:, None, :]
    inner = inner.masked_fill(~valid, -math.inf)
    max0, max1 = inner.max(2), inner.max(1)
    m0, m1 = max0.indices, max1.indices
    i0 = torch.arange(m0.shape[1], device=m0.device)[None]
    i1 = torch.arange(m1.shape[1], device=m1.device)[None]
    mutual0 = (m1.gather(1, m0) == i0) & mask0
    mutual1 = (m0.gather(1, m1) == i1) & mask1
    zero = inner.new_tensor(0)
    ms0 = torch.where(mutual0, max0.values.exp(), zero)
    ms1 = torch.where(mutual1, ms0.gather(1, m1), zero)
    valid0 = mutual0 & (ms0 > th)
    valid1 = mutual1 & valid0.gather(1, m1)
    return (torch.where(valid0, m0, -1), torch.where(valid1, m1, -1),
            ms0, ms1)
