"""The numbers that decide ``correct``, each read against the plain
reference (``reference.py``) and held to the limit the cell's workload file
gives it.

Training (the first three steps of the timed object, on three distinct
batches): ``loss_gap``, the largest relative gap of a step's loss;
``grad_gap``, of the first gradient as the optimizer got it (Adam's first
moment after one step, over 1 - b1), by the worst leaf: the gap between the
program's norm of that leaf and the reference's, over the reference's norm
of that leaf or of the median leaf, whichever is larger; ``change_gap``,
the same of each leaf's change over the three steps, leaving out leaves
whose reference gradient is under a thousandth of the median leaf's (round
-off moves them under Adam); ``grad_med`` and ``change_med``, the same
gaps of the median leaf, steady where a few leaves swing (a raw cloud's
points that lie within rounding of a ball query's sphere fall either way
in float32); ``gt_mismatch``, the ground-truth entries the program derived
otherwise than the reference where float32 distances cannot decide either
way (an exact count; ``reference.ground_truth``). A cell compares the
numbers its workload file gives a limit.

Matching (sampled answers of the window): ``match_gap``, the widest gap by
which the reference's log transport at a row's or column's chosen match
(the dustbin when unmatched) lies below that row's or column's best;
``score_err``, the largest difference between a matched keypoint's score
and the reference's transport probability at the chosen match; for the
eval pipeline also ``gt_mismatch`` and ``loss_gap``, the largest relative
gap of a pair's gap loss, which reads every entry of the transport, over
the pairs whose ground truth float32 cannot decide otherwise.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

GRAD_RULE = 1e-3     # leaves under this share of the median leaf's gradient


def _median(values: Sequence[float]) -> float:
    v = sorted(values)
    n = len(v)
    return 0.5 * (v[(n - 1) // 2] + v[n // 2])


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              names: List[str]) -> List[float]:
    """Each leaf's gap of norms over the reference's norm of that leaf or
    of the median leaf, whichever is larger."""
    med = _median([ref[k] for k in names])
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-300) for k in names]


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tensors.items()}


def train_readings(prog: Dict, ref: Dict, start: Dict[str, torch.Tensor]
                   ) -> Dict[str, float]:
    """``prog`` / ``ref``: ``losses`` (three floats), ``grads`` and
    ``after`` (tensors by leaf name), ``gt`` (pairs of [B, N] / [B, M]
    index tensors, one a batch); ``start`` the weights both began from."""
    names = sorted(ref["grads"])
    loss_gap = max(abs(p - r) / max(abs(r), 1e-300)
                   for p, r in zip(prog["losses"], ref["losses"]))
    g_p, g_r = _norms({k: prog["grads"][k] for k in names}), \
        _norms({k: ref["grads"][k] for k in names})
    med = _median([g_r[k] for k in names])
    moved = [k for k in names if g_r[k] >= GRAD_RULE * med]
    c_p = _norms({k: prog["after"][k].double() - start[k].double()
                  for k in moved})
    c_r = _norms({k: ref["after"][k].double() - start[k].double()
                  for k in moved})
    mismatch = sum(int(((a.long() != b.long().to(a.device))
                        & c.to(a.device)).sum())
                   for pg, rg, cl in zip(prog["gt"], ref["gt"], ref["clear"])
                   for a, b, c in zip(pg, rg, cl))
    grad, change = leaf_gaps(g_p, g_r, names), leaf_gaps(c_p, c_r, moved)
    return {"loss_gap": loss_gap, "grad_gap": max(grad),
            "change_gap": max(change), "grad_med": _median(grad),
            "change_med": _median(change), "gt_mismatch": float(mismatch)}


def match_readings(m0, m1, s0, s1, mask0, mask1, dense, bin_row, bin_col
                   ) -> Dict[str, float]:
    """Answers ``m0`` [B, N] / ``m1`` [B, M] (-1 unmatched) and scores
    ``s0`` / ``s1`` against the reference's log transport (``dense`` [B, N,
    M], ``bin_row`` [B, M], ``bin_col`` [B, N]), over valid rows and
    columns."""
    dt = dense.dtype
    m0, m1 = m0.long(), m1.long()
    both = mask0[:, :, None] & mask1[:, None, :]
    d = torch.where(both, dense, -math.inf)
    best0 = torch.maximum(d.amax(dim=2), bin_col)
    at0 = torch.where(m0 >= 0, torch.gather(d, 2, m0.clamp_min(0)[..., None])
                      [..., 0], bin_col)
    best1 = torch.maximum(d.amax(dim=1), bin_row)
    at1 = torch.where(m1 >= 0, torch.gather(d, 1, m1.clamp_min(0)[:, None, :])
                      [:, 0, :], bin_row)
    gaps = torch.cat([(best0 - at0)[mask0], (best1 - at1)[mask1]])
    err0 = (s0.to(dt) - torch.exp(at0)).abs()[(m0 >= 0) & mask0]
    err1 = (s1.to(dt) - torch.exp(at1)).abs()[(m1 >= 0) & mask1]
    errs = torch.cat([err0, err1])
    return {"match_gap": float(gaps.max()) if gaps.numel() else 0.0,
            "score_err": float(errs.max()) if errs.numel() else 0.0}


def loss_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest relative gap of a pair's loss."""
    p, r = prog.double().flatten(), ref.double().flatten().to(prog.device)
    if not p.numel():
        return 0.0
    return float(((p - r).abs() / r.abs().clamp_min(1e-300)).max())


def merge_max(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """The largest of each number over several readings (gt counts add)."""
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            if k == "gt_mismatch":
                out[k] = out.get(k, 0.0) + v
            else:
                out[k] = max(out.get(k, -math.inf), v)
    return out


def judge(readings: Dict[str, float], limits: Dict[str, float]):
    """(correct, checks): every number the cell has a limit for finite
    and at most it; the numbers without one are not compared."""
    checks = {k: {"value": float(readings[k]), "limit": float(v)}
              for k, v in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
