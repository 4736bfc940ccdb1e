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

Both kernels run a pair on a thread-block cluster of CTAs, each owning a
band of rows. The forward's cluster size comes from :func:`sinkhorn_plan`
(for the call's pairs, or for those :func:`plan_as` names: the cluster
size sets the order of the column sums, so a batch's rows come out
bit-equal only under one plan);
the band stays in shared memory wherever it fits (:func:`fwd_smem_bytes`
mirrors the kernel's layout). Above 1024 columns (or where a band's
vectors do not fit in shared memory) both kernels take their wide arm,
whose vectors live in a scratch tensor (:func:`fwd_scratch_floats`,
:func:`bwd_plan`): device memory is the only limit on N and M.

A CUDA tensor launches the kernels (float32 scores only); a CPU tensor takes
:func:`log_optimal_transport_reference`, the plain transport of
``ops/transport.py``, which autograd differentiates through its unrolled
loop. Nothing falls back: a CUDA call the kernels cannot take raises. The
backward keeps the replay's history (v and each row's logsumexp) in a
scratch tensor of ``B x ((iters + 1) (M + 2) + iters N)`` floats, so it
takes every iteration count.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
from typing import Optional

import torch

from mdgat_tpu_torch.ops.cuda._build import _ptr, device_scratch, library
from mdgat_tpu_torch.ops.cuda.layer import NUM_SMS
from mdgat_tpu_torch.ops.transport import (BIG_NEG, OTScores,
                                           log_optimal_transport,
                                           transport_marginals)
from mdgat_tpu_torch.utils.counting import tick

REGISTER_COLS = 1024      # columns the register arms take (kMaxCols)
MAX_CLUSTER = 16          # CTAs a pair; above 8 the size is non-portable
SMEM_CAP = 227 * 1024     # shared memory a CTA may take on the H100
FWD_THREADS = 1024        # threads a forward CTA (csrc/sinkhorn.cu kThreads)
BWD_STREAMED_THREADS = 512  # threads a streamed backward CTA (threads_for(0))


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
    if m <= 0 or n <= 0:
        raise ValueError(f"Sinkhorn kernel: {n} x {m} block")


def _pad4(n: int) -> int:
    return (n + 3) // 4 * 4


def fwd_smem_bytes(band: int, m: int, resident: bool) -> int:
    """Shared memory of one forward CTA (``csrc/sinkhorn.cu::
    fwd_smem_floats``): the bin scalars, ``lnu`` / ``v``, ``lmu`` / ``u``
    of the band, the row groups' partials, two exchange buffers and, when
    resident, the band of masked scores."""
    mp = _pad4(m)
    floats = (4 + 2 * mp + 2 * _pad4(band) + 2 * FWD_THREADS + 4 * (mp + 4)
              + (band * m if resident else 0))
    return 4 * floats


def fwd_wide(n: int, m: int, cluster: int) -> bool:
    """Whether the forward takes its wide arm at that cluster size: more
    than 1024 columns, or a band whose streamed vectors do not fit in
    shared memory (``csrc/sinkhorn.cu::wide_arm``)."""
    return (m > REGISTER_COLS
            or fwd_smem_bytes(-(-n // cluster), m, False) > SMEM_CAP)


def fwd_resident(n: int, m: int, cluster: int) -> bool:
    """Whether the forward keeps its band of ``ceil(n / cluster)`` rows in
    shared memory (the launch decides the same way)."""
    return (not fwd_wide(n, m, cluster)
            and fwd_smem_bytes(-(-n // cluster), m, True) <= SMEM_CAP)


def fwd_scratch_floats(b: int, n: int, m: int, cluster: int) -> int:
    """Floats of the wide forward's scratch (v, u and the exchange buffers
    of every CTA, ``csrc/sinkhorn.cu::wide_fwd_floats``); 0 where the
    launch takes a register arm."""
    if not fwd_wide(n, m, cluster):
        return 0
    mp = _pad4(m)
    return b * cluster * (mp + _pad4(-(-n // cluster)) + 4 * (mp + 4))


def _spread(b: int, n: int, g: int, top: int) -> int:
    """``g`` doubled up to ``top`` while the batch still fits in one wave
    of the card's SMs, then cut while the last CTA would get no row."""
    while g < top and b * 2 * g <= NUM_SMS:
        g *= 2
    while g > 1 and (g - 1) * -(-n // g) >= n:
        g //= 2
    return g


def sinkhorn_plan(b: int, n: int, m: int):
    """``(cluster, resident)`` of the forward for ``b`` pairs of ``n x m``
    scores: the smallest cluster whose band stays in shared memory
    (streamed, clusters of 8, where none does: at 8 pairs x 1024 columns 16
    CTAs a pair leave 7 clusters on the card at once, two waves), doubled
    up to 8 while the batch still fits in one wave of the card's SMs, and
    cut while the last CTA would get no row. The wide arm starts at 8 and
    doubles up to 16 (its CTAs hold no band, so a small batch spreads)."""
    if fwd_wide(n, m, 8):
        g = _spread(b, n, 8, MAX_CLUSTER)
        return g, fwd_resident(n, m, g)
    fit = [g for g in (1, 2, 4, 8, MAX_CLUSTER) if fwd_resident(n, m, g)]
    g = _spread(b, n, fit[0] if fit else 8, 8)
    return g, fwd_resident(n, m, g)


def bwd_smem_bytes(band: int, m: int) -> int:
    """Shared memory of one streamed backward CTA (``csrc/sinkhorn_bwd.cu::
    smem_floats`` at R = 0): lnu, v, v_prev, dv, two exchange buffers,
    lmu and u of the band, the warps' column partials."""
    mp = _pad4(m)
    return 4 * (4 * mp + 2 * (mp + 4) + 2 * _pad4(band)
                + BWD_STREAMED_THREADS // 32 * mp)


def bwd_wide(n: int, m: int, cluster: int) -> bool:
    """Whether the backward takes its wide arm at that cluster size: more
    than 1024 columns, or a streamed band that does not fit in shared
    memory (``csrc/sinkhorn_bwd.cu``: not ``fits_streamed``)."""
    return (m > REGISTER_COLS
            or bwd_smem_bytes(-(-n // cluster), m) > SMEM_CAP)


def bwd_scratch_floats(b: int, n: int, m: int, cluster: int) -> int:
    """Floats of the wide backward's scratch (``B x cluster x
    wide_bwd_floats``: v_t, v_{t-1}, dv, two exchange buffers, the rows'
    logsumexp and -du); 0 where the launch takes a register arm."""
    if not bwd_wide(n, m, cluster):
        return 0
    mp = _pad4(m)
    return b * cluster * (3 * mp + 2 * (mp + 4) + 2 * _pad4(-(-n // cluster)))


def bwd_plan(b: int, n: int, m: int):
    """``(cluster, scratch_floats)`` of the backward: ``(0, 0)`` where the
    launch plans a register arm itself (up to 1024 columns, a streamed band
    of clusters of 8 in shared memory); else the wide arm's cluster (from
    8, doubled up to 16 as the forward's) and its scratch."""
    if not bwd_wide(n, m, 8):
        return 0, 0
    g = _spread(b, n, 8, MAX_CLUSTER)
    return g, bwd_scratch_floats(b, n, m, g)


# the pair count the forward plans for (None: the call's own)
_PLAN_PAIRS = contextvars.ContextVar("mdgat_sinkhorn_plan_pairs",
                                     default=None)


@contextlib.contextmanager
def plan_as(pairs: int):
    """Inside the block the forward takes the cluster size
    :func:`sinkhorn_plan` gives ``pairs`` pairs, whatever the pair count of
    a call (per thread). The one-process grid
    (``parallel/smap.py::make_eval_runtime``) runs each data replica's
    block of rows under the plan of the whole batch, so that its rows come
    out as one device computes them."""
    token = _PLAN_PAIRS.set(int(pairs))
    try:
        yield
    finally:
        _PLAN_PAIRS.reset(token)


def planned_pairs() -> Optional[int]:
    """The pair count of the enclosing :func:`plan_as` block (this
    thread's), None outside one: a CUDA graph bakes the cluster size in,
    so ``utils/graphs.py::Captured`` keys its graphs on it."""
    return _PLAN_PAIRS.get()


def _forward(scores, scalars, log_mu, log_nu, iters: int,
             cluster: int = 0) -> OTScores:
    """One launch of the forward. ``cluster`` 0 takes
    :func:`sinkhorn_plan`'s cluster size (for the pairs of :func:`plan_as`
    inside one); 1-16 asks for that many CTAs a pair (the smoke's sweep)."""
    b, n, m = scores.shape
    cluster = cluster or sinkhorn_plan(_PLAN_PAIRS.get() or b, n, m)[0]
    if not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"Sinkhorn kernel: {cluster} CTAs a pair "
                         f"(1-{MAX_CLUSTER})")
    dense = torch.empty_like(scores)
    bin_row = torch.empty((b, m), dtype=scores.dtype, device=scores.device)
    bin_col = torch.empty((b, n), dtype=scores.dtype, device=scores.device)
    corner = torch.empty((b,), dtype=scores.dtype, device=scores.device)
    floats = fwd_scratch_floats(b, n, m, cluster)
    scratch = device_scratch(floats, scores.device,
                             f"Sinkhorn forward ({n} x {m})")
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        library().call("mdgat_sinkhorn", scores.data_ptr(), log_mu.data_ptr(),
                       log_nu.data_ptr(), scalars.data_ptr(), dense.data_ptr(),
                       bin_row.data_ptr(), bin_col.data_ptr(),
                       corner.data_ptr(), _ptr(scratch), floats, b, n, m,
                       int(iters), int(cluster), stream)
    tick(log_optimal_transport_kernel)
    return OTScores(dense, bin_row, bin_col, corner)


def active_clusters(n: int, m: int, cluster: int) -> int:
    """How many forward clusters of that launch the current card holds at
    once (``cudaOccupancyMaxActiveClusters``): a batch of ``b`` pairs runs
    in ``ceil(b / it)`` waves."""
    count = ctypes.c_int(0)
    library().call("mdgat_sinkhorn_active_clusters", n, m, int(cluster),
                   ctypes.addressof(count))
    return count.value


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
    ``cluster`` 0 takes the plan (:func:`bwd_plan`: the launch's own in
    ``csrc/`` for the register arms, the wide arm's cluster else); 1-16
    asks for that cluster size (the smoke's sweep)."""
    b, n, m = scores.shape
    if not 0 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"Sinkhorn backward: {cluster} CTAs a pair "
                         f"(1-{MAX_CLUSTER})")
    dz = torch.empty_like(scores)
    dalpha = torch.empty((b,), dtype=scores.dtype, device=scores.device)
    # the replay's history: v, vbin and the bin row's logsumexp [iters + 1,
    # M + 2], then each row's logsumexp [iters, N] (csrc/sinkhorn_bwd.cu:
    # hist_floats)
    hist = torch.empty((b, (iters + 1) * (m + 2) + iters * n),
                       dtype=scores.dtype, device=scores.device)
    if cluster == 0:
        cluster, floats = bwd_plan(b, n, m)
    else:
        floats = bwd_scratch_floats(b, n, m, cluster)
    scratch = device_scratch(floats, scores.device,
                             f"Sinkhorn backward ({n} x {m})")
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        library().call("mdgat_sinkhorn_bwd", scores.data_ptr(),
                       log_mu.data_ptr(), log_nu.data_ptr(),
                       scalars.data_ptr(), *(t.data_ptr() for t in cot),
                       dz.data_ptr(), dalpha.data_ptr(), hist.data_ptr(),
                       _ptr(scratch), floats, b, n, m, int(iters),
                       int(cluster), stream)
    tick(log_optimal_transport_kernel, "backward_launches")
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
