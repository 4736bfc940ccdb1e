"""Gap-loss margin kernels (``csrc/gap_loss.cu``) and their twins.

Mirror of ``mdgat_tpu/ops/pallas/loss.py``: :func:`fused_gap_margins` is
everything of the gap loss that touches the dense ``[B, N, M]`` transport
block, the pre-log margin sums ``S0 [B, N]`` (anchors = rows) and ``S1
[B, M]`` (anchors = columns). Its forward replaces ``_gap_fwd_kernel``, its
backward ``_gap_bwd_kernel`` (``dd [B, N, M]``, ``dbin_row``, ``dbin_col``; no
gradient for the ground truth, the masks or gamma). :func:`gap_loss_kernel`
is the drop-in for :func:`mdgat_tpu_torch.ops.losses.gap_loss` (mirror of
``pallas_gap_loss``): the ``2 * log1p``, the masked anchor means and the
average of the two directions stay plain tensor code, exactly as the JAX
package keeps them outside its kernel. See the note in ``csrc/gap_loss.cu``
for the design and what bounds it on the H100.

The forward also produces each anchor's count of active margins, which the
autograd function keeps: with them the backward reads the block once and
writes ``dd`` once. Each is one launch, a pair on a cluster of CTAs by
:func:`gap_plan`.

A CUDA tensor launches the kernels (float32, contiguous, any number of rows
and columns: the kernels take columns in chunks of 1024 and a CTA's rows in
pieces of 1024; anything else raises, nothing falls back). A CPU
tensor takes the plain twins :func:`fused_gap_margins_reference` and
:func:`fused_gap_margins_backward_reference` (with
:func:`fused_gap_counts_reference` for the counts), the formulas of the TPU
kernels' bodies written out (not autograd over ``ops/losses.gap_loss``), in
the tensor's own dtype.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mdgat_tpu_torch.ops.cuda._build import _ptr, library
from mdgat_tpu_torch.ops.cuda.layer import NUM_SMS
from mdgat_tpu_torch.ops.cuda.train_layer import _launch
from mdgat_tpu_torch.ops.losses import _masks, _mean_over
from mdgat_tpu_torch.ops.transport import BIG_NEG, OTScores
from mdgat_tpu_torch.utils.counting import tick

PIECE = 1024         # rows of a band a CTA stages at a time (kGapPiece)
MAX_CLUSTER = 16     # CTAs a pair; above 8 non-portable


def _direction0(dense, bin_col, gt0, cm):
    """Anchors = rows: (d0 [B, N, M], is_pos [B, N, M], at_bin [B, N],
    pos [B, N, 1]). A ground-truth index outside ``[-1, M]`` matches no
    column and gives a positive score of 0."""
    m = dense.shape[2]
    d0 = dense if cm is None else torch.where(cm[:, None, :], dense, BIG_NEG)
    pos_idx = torch.where(gt0 < 0, m, gt0)
    is_pos = (torch.arange(m, device=dense.device)[None, None, :]
              == pos_idx[:, :, None])
    pos_main = torch.where(is_pos, d0, 0.0).sum(dim=2)
    at_bin = pos_idx == m
    pos = torch.where(at_bin, bin_col, pos_main)
    return d0, is_pos, at_bin, pos[:, :, None]


def _direction1(dense, bin_row, gt1, rm):
    """Anchors = columns: (d1, is_pos [B, N, M], at_bin [B, M], pos
    [B, 1, M])."""
    n = dense.shape[1]
    d1 = dense if rm is None else torch.where(rm[:, :, None], dense, BIG_NEG)
    pos_idx = torch.where(gt1 < 0, n, gt1)
    is_pos = (torch.arange(n, device=dense.device)[None, :, None]
              == pos_idx[:, None, :])
    pos_main = torch.where(is_pos, d1, 0.0).sum(dim=1)
    at_bin = pos_idx == n
    pos = torch.where(at_bin, bin_row, pos_main)
    return d1, is_pos, at_bin, pos[:, None, :]


def fused_gap_margins_reference(dense, bin_row, bin_col, gt0, gt1, rm, cm,
                                gamma: float):
    """Plain twin of the forward kernel: ``(S0 [B, N], S1 [B, M])``.
    ``rm`` / ``cm`` are bool masks or None (all valid)."""
    dt = dense.dtype
    d0, is_pos0, at_bin0, pos0 = _direction0(dense, bin_col, gt0, cm)
    contrib0 = torch.relu(d0 - pos0 + gamma) * (~is_pos0).to(dt)
    bin_term0 = torch.relu(bin_col - pos0[:, :, 0] + gamma) * (~at_bin0).to(dt)
    d1, is_pos1, at_bin1, pos1 = _direction1(dense, bin_row, gt1, rm)
    contrib1 = torch.relu(d1 - pos1 + gamma) * (~is_pos1).to(dt)
    bin_term1 = torch.relu(bin_row - pos1[:, 0, :] + gamma) * (~at_bin1).to(dt)
    return contrib0.sum(dim=2) + bin_term0, contrib1.sum(dim=1) + bin_term1


def _indicators(dense, bin_row, bin_col, gt0, gt1, rm, cm, gamma):
    """Both directions' active margins: ``(is_pos0, at_bin0, i0 [B, N, M],
    bi0 [B, N, 1], is_pos1, at_bin1, i1 [B, N, M], bi1 [B, 1, M])``, each
    from the forward's f32 expression ``(cand - pos + gamma) > 0``."""
    d0, is_pos0, at_bin0, pos0 = _direction0(dense, bin_col, gt0, cm)
    i0 = ((d0 - pos0 + gamma) > 0) & ~is_pos0
    bi0 = ((bin_col[:, :, None] - pos0 + gamma) > 0) & ~at_bin0[:, :, None]
    d1, is_pos1, at_bin1, pos1 = _direction1(dense, bin_row, gt1, rm)
    i1 = ((d1 - pos1 + gamma) > 0) & ~is_pos1
    bi1 = ((bin_row[:, None, :] - pos1 + gamma) > 0) & ~at_bin1[:, None, :]
    return is_pos0, at_bin0, i0, bi0, is_pos1, at_bin1, i1, bi1


def fused_gap_counts_reference(dense, bin_row, bin_col, gt0, gt1, rm, cm,
                               gamma: float):
    """Plain twin of the counts the forward kernel keeps for the backward:
    ``(cnt0 [B, N], cnt1 [B, M])``, each anchor's number of active margins,
    the dustbin's included, in the scores' dtype."""
    dt = dense.dtype
    _, _, i0, bi0, _, _, i1, bi1 = _indicators(dense, bin_row, bin_col, gt0,
                                               gt1, rm, cm, gamma)
    return (i0.to(dt).sum(dim=2) + bi0[:, :, 0].to(dt),
            i1.to(dt).sum(dim=1) + bi1[:, 0, :].to(dt))


def fused_gap_margins_backward_reference(dense, bin_row, bin_col, gt0, gt1,
                                         rm, cm, gamma: float, ds0, ds1):
    """Plain twin of the backward kernel: ``(dd [B, N, M], dbin_row [B, M],
    dbin_col [B, N])`` from the cotangents ``ds0 [B, N]``, ``ds1 [B, M]``."""
    dt = dense.dtype
    ds0, ds1 = ds0.to(dt)[:, :, None], ds1.to(dt)[:, None, :]
    (is_pos0, at_bin0, i0, bi0, is_pos1, at_bin1, i1,
     bi1) = _indicators(dense, bin_row, bin_col, gt0, gt1, rm, cm, gamma)

    i0f, bi0f = i0.to(dt), bi0.to(dt)
    dpos0 = -ds0 * (i0f.sum(dim=2, keepdim=True) + bi0f)
    dd0 = ds0 * i0f + is_pos0.to(dt) * dpos0
    if cm is not None:
        dd0 = dd0 * cm[:, None, :].to(dt)
    dbin_col = at_bin0[:, :, None].to(dt) * dpos0 + ds0 * bi0f

    i1f, bi1f = i1.to(dt), bi1.to(dt)
    dpos1 = -ds1 * (i1f.sum(dim=1, keepdim=True) + bi1f)
    dd1 = ds1 * i1f + is_pos1.to(dt) * dpos1
    if rm is not None:
        dd1 = dd1 * rm[:, :, None].to(dt)
    dbin_row = at_bin1[:, None, :].to(dt) * dpos1 + ds1 * bi1f
    return dd0 + dd1, dbin_row[:, 0, :], dbin_col[:, :, 0]


def _check(dense, bin_row, bin_col, gt0, gt1, rm, cm):
    b, n, m = dense.shape
    if dense.dtype != torch.float32:
        raise ValueError(f"gap-loss kernels take float32 scores, not "
                         f"{dense.dtype}")
    _check_block(b, n, m)
    shapes = ((bin_row, (b, m), torch.float32), (bin_col, (b, n), torch.float32),
              (gt0, (b, n), torch.int32), (gt1, (b, m), torch.int32),
              (rm, (b, n), torch.bool), (cm, (b, m), torch.bool))
    for t, shape, dtype in ((dense, (b, n, m), torch.float32),) + shapes:
        if t is None:
            continue
        if (t.device != dense.device or tuple(t.shape) != shape
                or t.dtype != dtype or not t.is_contiguous()):
            raise ValueError("gap-loss kernels take contiguous tensors on "
                             "one CUDA device: dense, bin_row, bin_col "
                             "float32, gt0, gt1 int32, masks bool; got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _check_block(b: int, n: int, m: int):
    if n <= 0 or m <= 0 or not 0 < b <= 65535:
        raise ValueError(f"gap-loss kernels: {b} x {n} x {m} block (at least "
                         f"one row and one column, at most 65535 pairs)")


def _cut(n: int, g: int) -> int:
    """``g`` halved while the last CTA would get no row."""
    while g > 1 and (g - 1) * -(-n // g) >= n:
        g //= 2
    return g


def gap_plan(b: int, n: int, m: int):
    """``(cluster, band)`` of the forward for ``b`` pairs of ``n x m``
    scores: a pair on a cluster of ``cluster`` CTAs, CTA ``r`` taking the
    rows ``[r * band, min(n, (r + 1) * band))``. The cluster doubles from 1
    (up to 16) while the batch, doubled, still fits in one wave of one CTA
    an SM, or while a band would pass 1024 rows (a CTA stages its band's
    row side 1024 rows at a time), and is cut while the last CTA would get
    no row. The columns do not move the plan: the kernel takes them in
    chunks."""
    _check_block(b, n, m)
    g = 1
    while g < MAX_CLUSTER and (b * 2 * g <= NUM_SMS or -(-n // g) > PIECE):
        g *= 2
    g = _cut(n, g)
    return g, -(-n // g)


def active_clusters(m: int, cluster: int, backward: bool = False) -> int:
    """How many clusters of ``cluster`` CTAs of the forward's (or the
    backward's) launch for ``m`` columns the current card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    count = ctypes.c_int(0)
    library().call("mdgat_gap_active_clusters", m, int(cluster),
                   int(backward), ctypes.addressof(count))
    return count.value


def _cluster_band(b: int, n: int, m: int, cluster: int, what: str):
    """:func:`gap_plan`'s ``(cluster, band)``, or ``cluster`` 1-16 CTAs a
    pair with bands of ``ceil(n / cluster)`` rows (the smoke's sweeps)."""
    if not cluster:
        return gap_plan(b, n, m)
    if not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"gap-loss {what}: {cluster} CTAs a pair "
                         f"(1-{MAX_CLUSTER})")
    return cluster, -(-n // cluster)


def _margins_forward(dense, bin_row, bin_col, gt0, gt1, rm, cm, gamma,
                     cluster: int = 0):
    """The forward launch: ``(S0, S1, cnt0, cnt1)``, the counts of active
    margins per anchor as exact float32 integers for the backward. The
    pairs run on clusters of CTAs by :func:`gap_plan`; ``cluster`` 1-16
    asks for that many CTAs a pair instead (the smoke's sweep)."""
    _check(dense, bin_row, bin_col, gt0, gt1, rm, cm)
    b, n, m = dense.shape
    cluster, band = _cluster_band(b, n, m, cluster, "forward")
    f32, dev = torch.float32, dense.device
    s0, cnt0 = (torch.empty((b, n), dtype=f32, device=dev) for _ in range(2))
    s1, cnt1 = (torch.empty((b, m), dtype=f32, device=dev) for _ in range(2))
    _launch("mdgat_gap_fwd", dense, dense.data_ptr(), bin_row.data_ptr(),
            bin_col.data_ptr(), gt0.data_ptr(), gt1.data_ptr(), _ptr(rm),
            _ptr(cm), s0.data_ptr(), s1.data_ptr(), cnt0.data_ptr(),
            cnt1.data_ptr(), b, n, m, cluster, band, gamma)
    tick(fused_gap_margins, "forward_launches")
    return s0, s1, cnt0, cnt1


def _margins_backward(dense, bin_row, bin_col, gt0, gt1, rm, cm, gamma, cnt0,
                      cnt1, ds0, ds1, cluster: int = 0):
    """The backward launch: ``(dd, dbin_row, dbin_col)`` from the forward's
    operands and counts and the float32 cotangents. The pairs run on
    clusters of CTAs by :func:`gap_plan`, as the forward's; ``cluster``
    1-16 asks for that many CTAs a pair instead (the smoke's sweep)."""
    b, n, m = dense.shape
    cluster, band = _cluster_band(b, n, m, cluster, "backward")
    if (ds0.shape != (b, n) or ds1.shape != (b, m)
            or any(t.dtype != torch.float32 or not t.is_contiguous()
                   or t.device != dense.device for t in (ds0, ds1, cnt0, cnt1))):
        raise ValueError("gap-loss backward kernel: cotangent or count "
                         "shapes, dtypes or devices")
    dd = torch.empty_like(dense)
    dbin_row, dbin_col = torch.empty_like(bin_row), torch.empty_like(bin_col)
    _launch("mdgat_gap_bwd", dense, dense.data_ptr(), bin_row.data_ptr(),
            bin_col.data_ptr(), gt0.data_ptr(), gt1.data_ptr(), _ptr(rm),
            _ptr(cm), cnt0.data_ptr(), cnt1.data_ptr(), ds0.data_ptr(),
            ds1.data_ptr(), dd.data_ptr(), dbin_row.data_ptr(),
            dbin_col.data_ptr(), b, n, m, cluster, band, gamma)
    tick(fused_gap_margins, "backward_launches")
    return dd, dbin_row, dbin_col


class _GapMargins(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dense, bin_row, bin_col, gt0, gt1, rm, cm, gamma):
        ctx.gamma = gamma
        operands = (dense, bin_row, bin_col, gt0, gt1, rm, cm)
        if dense.device.type == "cpu":
            ctx.save_for_backward(*operands)
            return fused_gap_margins_reference(*operands, gamma)
        s0, s1, cnt0, cnt1 = _margins_forward(*operands, gamma)
        ctx.save_for_backward(*operands, cnt0, cnt1)
        return s0, s1

    @staticmethod
    def backward(ctx, ds0, ds1):
        operands, counts = ctx.saved_tensors[:7], ctx.saved_tensors[7:]
        if operands[0].device.type == "cpu":
            grads = fused_gap_margins_backward_reference(
                *operands, ctx.gamma, ds0, ds1)
        else:
            grads = _margins_backward(
                *operands, ctx.gamma, *counts,
                ds0.to(torch.float32).contiguous(),
                ds1.to(torch.float32).contiguous())
        return (*grads, None, None, None, None, None)


def fused_gap_margins(dense, bin_row, bin_col, gt0, gt1, rm, cm,
                      gamma: float):
    """Pre-log gap-loss margin sums ``(S0 [B, N], S1 [B, M])``,
    differentiable in ``dense``, ``bin_row`` and ``bin_col``. ``gt0 [B, N]``
    / ``gt1 [B, M]`` are integer ground-truth indices (< 0 = unmatched), ``rm
    [B, N]`` / ``cm [B, M]`` bool masks or None (all valid). On a CUDA
    device: float32 contiguous scores, int32 ground truth."""
    return _GapMargins.apply(dense, bin_row, bin_col, gt0, gt1, rm, cm,
                             float(gamma))


# launches of the forward kernel and of the backward kernel
fused_gap_margins.forward_launches = 0
fused_gap_margins.backward_launches = 0


def gap_loss_kernel(ot: OTScores, gt0, gt1, gamma: float,
                    row_mask: Optional[torch.Tensor] = None,
                    col_mask: Optional[torch.Tensor] = None):
    """Drop-in for :func:`mdgat_tpu_torch.ops.losses.gap_loss`: the same
    ``[B]`` loss, the dense-block work in :func:`fused_gap_margins`. On a
    CUDA device the ground truth is cast to int32 and the scores are made
    contiguous here; a dtype other than float32 raises."""
    dense, bin_row, bin_col = ot.dense, ot.bin_row, ot.bin_col
    dt = dense.dtype
    if dense.device.type == "cuda":
        dense, bin_row, bin_col = (t.contiguous()
                                   for t in (dense, bin_row, bin_col))
        gt0, gt1 = gt0.to(torch.int32).contiguous(), gt1.to(torch.int32).contiguous()
        row_mask = None if row_mask is None else row_mask.contiguous()
        col_mask = None if col_mask is None else col_mask.contiguous()
    s0, s1 = fused_gap_margins(dense, bin_row, bin_col, gt0, gt1, row_mask,
                               col_mask, gamma)
    per_anchor0 = 2.0 * torch.log1p(s0).to(dt)
    per_anchor1 = 2.0 * torch.log1p(s1).to(dt)
    rm, cm = _masks(*ot.dense.shape, row_mask, col_mask, dense.device)
    return (_mean_over(per_anchor0, rm) + _mean_over(per_anchor1, cm)) / 2.0
