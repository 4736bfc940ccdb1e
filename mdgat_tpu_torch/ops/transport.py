"""Log-domain Sinkhorn optimal transport with dustbins, plain PyTorch.

Port of ``mdgat_tpu/ops/transport.py`` (reference ``models/mdgat.py:
279-308``). The ``(N+1) x (M+1)`` coupling stays decomposed into a dense
``[N, M]`` block, a bin row, a bin column and a corner. Padded rows and
columns carry the ``-1e30`` sentinel and zero marginal mass, and their
potentials start at the sentinel, so the transport on the valid block
equals the unpadded result.

Iteration (per batch element), matching ``log_sinkhorn_iterations``:
    u = log_mu - LSE_cols(Z + v)
    v = log_nu - LSE_rows(Z + u)
returning ``Z + u + v - norm`` with ``norm = -log(N_valid + M_valid)``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

BIG_NEG = -1e30


class OTScores(NamedTuple):
    """Decomposed (N+1)x(M+1) transport scores."""
    dense: torch.Tensor    # [B, N, M]
    bin_row: torch.Tensor  # [B, M]  (dustbin row: scores[:, -1, :-1])
    bin_col: torch.Tensor  # [B, N]  (dustbin col: scores[:, :-1, -1])
    corner: torch.Tensor   # [B]     (scores[:, -1, -1])


def _lse(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Logsumexp safe for rows filled with the big-negative sentinel."""
    m = x.amax(dim=dim, keepdim=True)
    return torch.log(torch.exp(x - m).sum(dim=dim)) + m.squeeze(dim)


def log_sinkhorn(dense, alpha, log_mu, log_mu_bin, log_nu, log_nu_bin,
                 iters: int):
    """Decomposed log-Sinkhorn; returns (u, u_bin, v, v_bin).

    dense [B, N, M] masked scores; alpha [B]; log_mu [B, N]; log_nu
    [B, M]; log_mu_bin / log_nu_bin [B].
    """
    b, n, m = dense.shape
    # padded potentials start at the sentinel: zero mass from iteration 0
    u = torch.zeros_like(log_mu).masked_fill(log_mu <= 0.5 * BIG_NEG, BIG_NEG)
    v = torch.zeros_like(log_nu).masked_fill(log_nu <= 0.5 * BIG_NEG, BIG_NEG)
    u_bin = torch.zeros(b, dtype=dense.dtype, device=dense.device)
    v_bin = torch.zeros(b, dtype=dense.dtype, device=dense.device)
    for _ in range(iters):
        row_main = _lse(dense + v[:, None, :], 2)                  # [B, N]
        row_bin = (alpha + v_bin)[:, None].expand(b, n)
        u = log_mu - torch.logaddexp(row_main, row_bin)
        ubr_main = _lse(alpha[:, None] + v, 1)                     # [B]
        u_bin = log_mu_bin - torch.logaddexp(ubr_main, alpha + v_bin)
        col_main = _lse(dense + u[:, :, None], 1)                  # [B, M]
        col_bin = (alpha + u_bin)[:, None].expand(b, m)
        v = log_nu - torch.logaddexp(col_main, col_bin)
        vbr_main = _lse(alpha[:, None] + u, 1)
        v_bin = log_nu_bin - torch.logaddexp(vbr_main, alpha + u_bin)
    return u, u_bin, v, v_bin


def transport_marginals(scores: torch.Tensor, alpha,
                        row_mask: Optional[torch.Tensor],
                        col_mask: Optional[torch.Tensor]):
    """(alpha [B], log_mu [B, N], log_nu [B, M], log_mu_bin [B],
    log_nu_bin [B], norm [B]) from the valid counts, exactly the
    reference's ``log_mu`` / ``log_nu`` built from the true sizes."""
    b, n, m = scores.shape
    dt, dev = scores.dtype, scores.device
    if row_mask is None:
        row_mask = torch.ones((b, n), dtype=torch.bool, device=dev)
    if col_mask is None:
        col_mask = torch.ones((b, m), dtype=torch.bool, device=dev)
    ns = row_mask.sum(dim=1).to(dt)
    ms = col_mask.sum(dim=1).to(dt)
    norm = -torch.log(ns + ms)
    log_mu = torch.where(row_mask, norm[:, None], BIG_NEG)
    log_nu = torch.where(col_mask, norm[:, None], BIG_NEG)
    a = torch.as_tensor(alpha, dtype=dt, device=dev).expand(b)
    return a, log_mu, log_nu, torch.log(ms) + norm, torch.log(ns) + norm, norm


def log_optimal_transport(scores: torch.Tensor, alpha, iters: int,
                          row_mask: Optional[torch.Tensor] = None,
                          col_mask: Optional[torch.Tensor] = None) -> OTScores:
    """OT in log space (``models/mdgat.py:288-308``). scores [B, N, M];
    alpha the learned dustbin score; masks [B, N] / [B, M] mark valid
    keypoints."""
    a, log_mu, log_nu, log_mu_bin, log_nu_bin, norm = transport_marginals(
        scores, alpha, row_mask, col_mask)
    valid = ((log_mu > 0.5 * BIG_NEG)[:, :, None]
             & (log_nu > 0.5 * BIG_NEG)[:, None, :])
    dense = torch.where(valid, scores, BIG_NEG)
    u, u_bin, v, v_bin = log_sinkhorn(dense, a, log_mu, log_mu_bin,
                                      log_nu, log_nu_bin, iters)
    out_dense = dense + u[:, :, None] + v[:, None, :] - norm[:, None, None]
    out_bin_row = a[:, None] + u_bin[:, None] + v - norm[:, None]
    out_bin_col = a[:, None] + u + v_bin[:, None] - norm[:, None]
    out_corner = a + u_bin + v_bin - norm
    return OTScores(out_dense, out_bin_row, out_bin_col, out_corner)


def assemble_full_scores(ot: OTScores) -> torch.Tensor:
    """Materialise the reference's [B, N+1, M+1] score matrix."""
    top = torch.cat([ot.dense, ot.bin_col[:, :, None]], dim=2)
    bottom = torch.cat([ot.bin_row, ot.corner[:, None]], dim=1)
    return torch.cat([top, bottom[:, None, :]], dim=1)
