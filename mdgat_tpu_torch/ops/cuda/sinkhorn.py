"""Dustbin log-Sinkhorn forward kernel (``csrc/sinkhorn.cu``) and its twin.

Replaces ``mdgat_tpu/ops/pallas/sinkhorn.py::pallas_log_optimal_transport``
/ ``_fwd_from_prep`` / ``_kernel`` (forward only). As there, the marginals
and the per-pair scalar pack stay plain tensor code around the kernel
(``_prep``), and the kernel masks the raw scores from the marginals. See
the source note in ``csrc/sinkhorn.cu`` for the design and what bounds it
on the H100.

A CUDA tensor launches the kernel (float32 scores only); a CPU tensor takes
:func:`log_optimal_transport_reference`, the plain transport of
``ops/transport.py``. Nothing falls back: a CUDA call the kernel cannot
take raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from mdgat_tpu_torch.ops.cuda._build import library
from mdgat_tpu_torch.ops.transport import (OTScores, log_optimal_transport,
                                           transport_marginals)

MAX_COLS = 1024


# the plain PyTorch twin of the kernel
log_optimal_transport_reference = log_optimal_transport


def _prep(scores, alpha, row_mask, col_mask):
    """(scalars [B, 4] = (alpha, log_mu_bin, log_nu_bin, norm), log_mu
    [B, N], log_nu [B, M]) -- ``_prep`` of the JAX kernel."""
    a, log_mu, log_nu, log_mu_bin, log_nu_bin, norm = transport_marginals(
        scores, alpha, row_mask, col_mask)
    scalars = torch.stack([a, log_mu_bin, log_nu_bin, norm], dim=1)
    return scalars.contiguous(), log_mu.contiguous(), log_nu.contiguous()


def log_optimal_transport_kernel(scores, alpha, iters: int,
                                 row_mask: Optional[torch.Tensor] = None,
                                 col_mask: Optional[torch.Tensor] = None
                                 ) -> OTScores:
    """Drop-in for :func:`~mdgat_tpu_torch.ops.transport.
    log_optimal_transport` (forward only)."""
    if scores.device.type == "cpu":
        return log_optimal_transport_reference(scores, alpha, iters,
                                               row_mask, col_mask)
    if scores.device.type != "cuda":
        raise ValueError(f"no Sinkhorn kernel for device {scores.device}")
    b, n, m = scores.shape
    if scores.dtype != torch.float32:
        raise ValueError(f"Sinkhorn kernel takes float32 scores, not "
                         f"{scores.dtype}")
    if not 0 < m <= MAX_COLS or n <= 0:
        raise ValueError(f"Sinkhorn kernel: {n} x {m} block (columns at "
                         f"most {MAX_COLS})")
    scores = scores.contiguous()
    scalars, log_mu, log_nu = _prep(scores, alpha, row_mask, col_mask)
    dense = torch.empty_like(scores)
    bin_row = torch.empty((b, m), dtype=scores.dtype, device=scores.device)
    bin_col = torch.empty((b, n), dtype=scores.dtype, device=scores.device)
    corner = torch.empty((b,), dtype=scores.dtype, device=scores.device)
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        library().call("mdgat_sinkhorn", scores.data_ptr(), log_mu.data_ptr(),
                       log_nu.data_ptr(), scalars.data_ptr(), dense.data_ptr(),
                       bin_row.data_ptr(), bin_col.data_ptr(),
                       corner.data_ptr(), b, n, m, int(iters), stream)
    log_optimal_transport_kernel.launches += 1
    return OTScores(dense, bin_row, bin_col, corner)


log_optimal_transport_kernel.launches = 0
