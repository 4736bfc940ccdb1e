"""Dustbin log-Sinkhorn kernels (``csrc/sinkhorn.cu``, ``csrc/
sinkhorn_bwd.cu``) and their twin.

:func:`log_optimal_transport_kernel` replaces ``mdgat_tpu/ops/pallas/
sinkhorn.py::pallas_log_optimal_transport`` and
``pallas_log_optimal_transport_trainable`` / ``_ot_trainable``: one entry for
serving and training. Its forward is the forward kernel (``_fwd_from_prep``
/ ``_kernel``); its backward is the replay kernel (``_bwd_call`` /
``_bwd_kernel``): exact reverse mode through the unrolled iterations, with
``dscores`` zeroed outside the valid block and ``dalpha`` summed over the
batch. As on the TPU, the marginals and the per-pair scalar pack stay plain
tensor code around the kernels (``_prep``), and the kernels mask the raw
scores from the marginals. See the source notes in ``csrc/``
for the designs and what bounds them on the H100.

A CUDA tensor launches the kernels (float32 scores only); a CPU tensor takes
:func:`log_optimal_transport_reference`, the plain transport of
``ops/transport.py``, which autograd differentiates through its unrolled
loop. Nothing falls back: a CUDA call the kernels cannot take raises (more
than 1024 columns). The backward keeps the replay's history (v and each
row's logsumexp) in a scratch tensor of ``B x ((iters + 1) (M + 2) + iters
N)`` floats, so it takes every iteration count.
"""

from __future__ import annotations

from typing import Optional

import torch

from mdgat_tpu_torch.ops.cuda._build import library
from mdgat_tpu_torch.ops.transport import (BIG_NEG, OTScores,
                                           log_optimal_transport,
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


def _check(scores):
    if scores.device.type != "cuda":
        raise ValueError(f"no Sinkhorn kernel for device {scores.device}")
    b, n, m = scores.shape
    if scores.dtype != torch.float32:
        raise ValueError(f"Sinkhorn kernel takes float32 scores, not "
                         f"{scores.dtype}")
    if not 0 < m <= MAX_COLS or n <= 0:
        raise ValueError(f"Sinkhorn kernel: {n} x {m} block (columns at "
                         f"most {MAX_COLS})")


def _forward(scores, scalars, log_mu, log_nu, iters: int) -> OTScores:
    b, n, m = scores.shape
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


class _KernelOT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, scores, alpha, row_mask, col_mask, iters):
        scalars, log_mu, log_nu = _prep(scores, alpha, row_mask, col_mask)
        ot = _forward(scores, scalars, log_mu, log_nu, iters)
        # raw scores + in-kernel masking: the residual is the score tensor
        ctx.save_for_backward(scores, scalars, log_mu, log_nu)
        ctx.iters = iters
        return tuple(ot)

    @staticmethod
    def backward(ctx, d_dense, d_bin_row, d_bin_col, d_corner):
        scores, scalars, log_mu, log_nu = ctx.saved_tensors
        cot = [t.to(scores.dtype).contiguous()
               for t in (d_dense, d_bin_row, d_bin_col, d_corner)]
        dz, dalpha = _backward(scores, scalars, log_mu, log_nu, cot, ctx.iters)
        half = 0.5 * BIG_NEG
        valid = (log_mu > half)[:, :, None] & (log_nu > half)[:, None, :]
        return (dz * valid.to(dz.dtype), dalpha.sum(), None, None, None)


def _backward(scores, scalars, log_mu, log_nu, cot, iters: int,
              cluster: int = 0):
    """One launch of the replay backward: (dZ [B, N, M], dalpha [B]).
    ``cluster`` 0 takes the launch's plan in ``csrc/`` (CTAs a pair);
    1-16 asks for that cluster size (the smoke's sweep)."""
    b, n, m = scores.shape
    dz = torch.empty_like(scores)
    dalpha = torch.empty((b,), dtype=scores.dtype, device=scores.device)
    # the replay's history: v, vbin and the bin row's logsumexp [iters + 1,
    # M + 2], then each row's logsumexp [iters, N] (csrc/sinkhorn_bwd.cu:
    # hist_floats)
    hist = torch.empty((b, (iters + 1) * (m + 2) + iters * n),
                       dtype=scores.dtype, device=scores.device)
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        library().call("mdgat_sinkhorn_bwd", scores.data_ptr(),
                       log_mu.data_ptr(), log_nu.data_ptr(),
                       scalars.data_ptr(), *(t.data_ptr() for t in cot),
                       dz.data_ptr(), dalpha.data_ptr(), hist.data_ptr(), b,
                       n, m, int(iters), int(cluster), stream)
    log_optimal_transport_kernel.backward_launches += 1
    return dz, dalpha


def log_optimal_transport_kernel(scores, alpha, iters: int,
                                 row_mask: Optional[torch.Tensor] = None,
                                 col_mask: Optional[torch.Tensor] = None
                                 ) -> OTScores:
    """Differentiable drop-in for :func:`~mdgat_tpu_torch.ops.transport.
    log_optimal_transport`, for serving and training alike: gradients
    reach ``scores`` and ``alpha`` (a number or a 0-dim tensor). Missing
    cotangents (an output the loss does not read) count as zeros. With
    gradients off nothing is kept for a backward."""
    if scores.device.type == "cpu":
        return log_optimal_transport_reference(scores, alpha, iters,
                                               row_mask, col_mask)
    _check(scores)
    alpha = torch.as_tensor(alpha, dtype=scores.dtype, device=scores.device)
    if alpha.dim() != 0:
        raise ValueError("Sinkhorn kernel: alpha must be a scalar")
    return OTScores(*_KernelOT.apply(scores.contiguous(), alpha, row_mask,
                                     col_mask, int(iters)))


# launches of the forward kernel and of the backward kernel
log_optimal_transport_kernel.launches = 0
log_optimal_transport_kernel.backward_launches = 0
