"""Whole attentional-propagation layer under TRAINING semantics on
hand-written kernels, forward and backward, and its plain twin.

Replaces ``mdgat_tpu/ops/pallas/attention.py::fused_train_layer`` (a custom
VJP over ``_tl_fwd_calls`` -> ``_tl_fwd1_kernel`` / ``_tl_fwd2_kernel`` and
``_ftl_bwd`` -> ``_tl_bwd1_kernel`` / ``_tl_bwd2_kernel``) and its entry
``fused_train_layer_apply``: ``y = x + MLP(cat(x, merge(MHA(x, source))))``
with batch-statistic BatchNorm inside the MLP, the residual inside the
layer, and the running statistics moved outside it.

What each TPU kernel becomes (``csrc/train_layer.cu`` has the new device
code; the attention and the plain products are the kernels the fused-MHA
pair already runs):

* fwd1, eight launches: q, k, v, attention (with ``thr`` / ``lse``) and the
  merge, exactly as ``ops/cuda/mha.py`` launches them, then
  :func:`h1_stats`: ``h1 = cat(x, msg) @ w1 + b1`` with the masked
  per-channel sum and sum of squares taken from the float32 accumulator in
  the epilogue (per-block partials under the row plan :func:`h1_plan`,
  then a fixed-order reduce).
* the mean / variance / BN-affine step between the two forward kernels is
  tensor code on ``[2D]`` vectors on the device, as it is XLA code outside
  the Pallas kernels; the count of valid rows stays a device tensor.
* fwd2, one launch: :func:`bn_relu_conv2`, ``y = x + relu(h1 * a + c) @ w2
  + b2`` with the affine and the ReLU applied once to each staged value of
  ``h1`` (rows split by :func:`fwd2_plan`).
* bwd1, four launches: :func:`bn_backward_sums` (``Sg``, ``Sgh``,
  ``dscale``, ``dbias`` over ALL rows, from ``dh2 = g @ w2^T`` formed tile by
  tile and never stored) and :func:`dw2_db2` (``relu(bn(h1))^T g`` and the
  column sums of ``g``, rows split by :func:`dw2_plan`), each with its
  fixed-order reduce.
* bwd2, 23 launches: :func:`dh1_kernel` writes ``dh1`` once; ``dmsg`` and
  ``g + dx_mlp`` by the transposed-W GEMM; the fifteen launches of the
  fused-MHA backward with ``g := dmsg`` and ``g + dx_mlp`` added in the last
  epilogue; the message again by the merge GEMM; ``dw1x`` / ``db1`` and
  ``dw1m`` by the transposed-A GEMM.

No ``torch.matmul``, cuBLAS, SDPA or autograd-through-the-MLP runs on a CUDA
tensor in either direction, and no atomics: every cross-row sum is per-block
partials added in a fixed order, so the gradients carry the same bits on
every run.

Semantics that differ from the unfused route (``ops/mlp.py::BatchNorm``),
as they differ in the JAX package: the variance is single-pass,
``max(ssq / cnt - mean^2, 0)`` in the accumulation dtype, and the running
variance moves towards that value times ``cnt / max(cnt - 1, 1)``. ``h1``
is stored in ``x``'s dtype; the sums are taken before that rounding and
everything downstream reads the stored value. The BN backward's two
reduction vectors run over every row, padded ones too (every row is
normalised with the batch statistics); the row mask enters only as the
factor on the centering correction of ``dh1``.

Under a data-parallel step (``ops/mlp.py::bn_cross_replica`` with a process
group, ``parallel/smap.py``) the statistics are the global batch's, as the
JAX package's ``axis_name`` psums make them: between the two forward kernel
groups the masked sums ``[2, 2D]`` and the row count go into one all-reduce
before the mean, the variance and the affine are formed; between the two
backward groups ``Sg`` and ``Sgh`` go into one all-reduce before ``vec6``
(``dscale`` and ``dbias`` are parameter gradients, averaged with the
others by the step); the running statistics move with the global count.
The collectives run on the tensors' device and stream, between the
launches; the group is taken when the forward runs and kept for the
backward. The twin does the same through differentiable all-reduces.

A CUDA tensor launches the kernels; a CPU tensor takes
:func:`fused_train_layer_reference` under autograd, built from the
kernels' own plain twins (:func:`h1_stats_reference`,
:func:`bn_relu_conv2_reference`, :func:`bn_backward_sums_plain`,
:func:`dw2_db2_reference`, :func:`dh1_reference`), which each wrapper also
takes on CPU tensors.
Nothing falls back, and
no size gate steps down to another route: a CUDA call the kernels cannot
take (a head size the attention kernel lacks, a scratch larger than the
card's free memory) raises; any number of keys is taken.
"""

from __future__ import annotations

from typing import Optional

import torch

from mdgat_tpu_torch.ops.attention import acc_dtype
from mdgat_tpu_torch.ops.cuda import mha
from mdgat_tpu_torch.ops.cuda._build import DTYPE_CODES, _ptr, library
from mdgat_tpu_torch.ops.cuda.layer import (NUM_SMS, TN_STAGE_ROWS, gemm,
                                           gemm_tn, tn_plan)
from mdgat_tpu_torch.ops.mlp import BN_EPS, BN_MOMENTUM, bn_group
from mdgat_tpu_torch.parallel.mesh import all_reduce

# row tiles of the csrc/train_layer.cu launches that take a row plan (the
# dw2 launch's are the A^T product's ring stages, layer.TN_STAGE_ROWS)
H1_TILE_ROWS = 128        # rows of x and msg in one tile of tl_h1_kernel
FWD2_TILE_ROWS = 128      # rows of h1 in one tile of tl_fwd2_kernel
DH2_TILE_ROWS = 64        # rows of g in one tile of tl_dh2_kernel


def train_layer_weights(layer):
    """The fourteen operands of an ``AttentionalPropagation`` in the
    accumulation dtype: the eight head-blocked attention weights of
    :func:`~mdgat_tpu_torch.ops.cuda.mha.blocked_weights`, then ``w1
    [2D, 2D]`` (rows ``[:D]`` multiply x, rows ``[D:]`` the message, which
    is in natural channel order and needs no permutation), ``b1 [2D]``,
    ``w2 [2D, D]``, ``b2 [D]`` in ``[in, out]`` layout, and the BatchNorm
    scale and bias ``[2D]``. Differentiable: autograd carries the kernels'
    gradients back to the ``Conv1x1`` / ``BatchNorm`` parameters."""
    conv1, bn, _, conv2 = layer.mlp
    dt = acc_dtype(conv1.weight.dtype)
    dense = lambda conv: conv.weight[:, :, 0].t().to(dt).contiguous()
    return (*mha.blocked_weights(layer.attn, layer.num_heads),
            dense(conv1), conv1.bias.to(dt), dense(conv2), conv2.bias.to(dt),
            bn.weight.to(dt), bn.bias.to(dt))


def _row_count(x, valid_mask, dtype):
    """Rows that enter this rank's batch statistics: a 0-dim tensor on
    ``x``'s device (no host sync), not yet floored at 1."""
    if valid_mask is None:
        return torch.full((), float(x.shape[0] * x.shape[1]), dtype=dtype,
                          device=x.device)
    return valid_mask.sum().to(dtype)


def _global_sums(sums, cnt, group, differentiable=False):
    """``(sums [2, 2D], cnt)`` over every rank of ``group`` (one all-reduce
    of both, counted as ``layer_bn``), or this rank's alone when ``group``
    is None; the count then floored at 1."""
    if group is not None:
        packed = torch.cat([sums.reshape(-1), cnt.reshape(1)])
        packed = all_reduce(packed, group, "layer_bn", differentiable)
        sums, cnt = packed[:-1].view_as(sums), packed[-1]
    return sums, cnt.clamp_min(1.0)


def _batch_stats(ssum, ssq, cnt):
    """Single-pass batch mean and biased variance from the masked sums."""
    mean = ssum / cnt
    return mean, ssq / cnt - mean * mean


def fused_train_layer_reference(x, source, kv_mask: Optional[torch.Tensor],
                                valid_mask: Optional[torch.Tensor],
                                topk: Optional[int], num_heads: int,
                                wq, bq, wk, bk, wv, bv, wm, bm, w1, b1, w2,
                                b2, bn_scale, bn_bias,
                                return_residuals: bool = False):
    """Plain PyTorch twin of :func:`fused_train_layer` on the same operands:
    ``(y, batch_mean, batch_var)``, or with ``return_residuals`` ``(y, mean,
    var, h1, thr, lse, ssum, ssq)``. Differentiable by autograd with the
    selection frozen; the variance is single-pass and ``h1`` is rounded to
    ``x``'s dtype where the kernels round it (module docstring). The clamp
    of the variance at zero passes its gradient straight through, as the
    kernels' backward formula does. ``ssum`` and ``ssq`` are this rank's
    sums; the statistics are the group's under ``bn_cross_replica``."""
    out = _reference(x, source, kv_mask, valid_mask, topk, num_heads, wq, bq,
                     wk, bk, wv, bv, wm, bm, w1, b1, w2, b2, bn_scale, bn_bias)
    return out[:3] + out[4:] if return_residuals else out[:3]


def _reference(x, source, kv_mask, valid_mask, topk, num_heads, wq, bq, wk,
               bk, wv, bv, wm, bm, w1, b1, w2, b2, bn_scale, bn_bias):
    """The twin's ``(y, mean, var, cnt, h1, thr, lse, ssum, ssq)``, ``cnt``
    the (global) row count floored at 1."""
    acc = acc_dtype(x.dtype)
    cast = lambda t: t.to(acc)
    msg, thr, lse = mha.fused_mha_reference(
        x, source, kv_mask, topk, num_heads, wq, bq, wk, bk, wv, bv, wm, bm,
        return_residuals=True, out_dtype=acc)
    h1, sums = h1_stats_reference(x, msg, w1, b1, valid_mask)
    h1 = h1.reshape(*x.shape[:2], -1)
    (ssum, ssq), cnt = _global_sums(sums, _row_count(x, valid_mask, acc),
                                    bn_group(), differentiable=True)
    mean, raw = _batch_stats(ssum, ssq, cnt)
    var = raw + (raw.clamp_min(0.0) - raw).detach()
    inv = torch.rsqrt(var + BN_EPS)
    a = cast(bn_scale) * inv
    y = bn_relu_conv2_reference(x, h1, a, cast(bn_bias) - mean * a, w2, b2)
    return (y, mean.detach(), var.detach(), cnt.detach(), h1.detach(), thr,
            lse, sums[0].detach(), sums[1].detach())


def h1_stats_reference(x, msg, w1, b1, row_mask):
    """Plain twin of :func:`h1_stats`: ``(h1 [R, 2D] in x's dtype, sums [2,
    2D])``, the sums (of ``h1 * m`` and ``h1^2 * m``, ``m`` the row mask,
    bool or uint8 with ``R`` entries, or None) taken in the accumulation
    dtype before the rounding to ``x``'s dtype. Differentiable."""
    acc = acc_dtype(x.dtype)
    d = x.shape[-1]
    w1f = w1.to(acc)
    h1f = (x.reshape(-1, d).to(acc) @ w1f[:d]
           + msg.reshape(-1, d).to(acc) @ w1f[d:] + b1.to(acc))
    h1m = (h1f if row_mask is None
           else h1f * row_mask.reshape(-1, 1).to(acc))
    return h1f.to(x.dtype), torch.stack([h1m.sum(0), (h1m * h1f).sum(0)])


def bn_relu_conv2_reference(x, h1, a, c, w2, b2):
    """Plain twin of :func:`bn_relu_conv2`: ``y = x + relu(h1 * a + c) @ w2
    + b2`` in the accumulation dtype, rounded to x's dtype; ``h1`` holds
    ``2D`` columns for each row of ``x [.., D]``. Differentiable."""
    acc = acc_dtype(x.dtype)
    cast = lambda t: t.to(acc)
    u = torch.relu(cast(h1).reshape(*x.shape[:-1], -1) * cast(a) + cast(c))
    return (cast(x) + (u @ cast(w2) + cast(b2))).to(x.dtype)


def _bn_rebuild(g, h1, mean, inv, bn_scale, bias):
    """``(g, hhat, bn)`` row by row in the accumulation dtype: ``hhat = (h1
    - mean) * inv``, ``bn = hhat * scale + bias``."""
    acc = acc_dtype(h1.dtype)
    gf = g.to(h1.dtype).to(acc).reshape(-1, g.shape[-1])
    hhat = (h1.to(acc).reshape(gf.shape[0], -1) - mean) * inv
    return gf, hhat, hhat * bn_scale + bias


def _bn_backward_rows(g, h1, w2, mean, inv, bn_scale, bn_bias):
    """``(g, hhat, bn, dbn, G)``: :func:`_bn_rebuild`'s, ``dbn = (g @
    w2^T) * (bn > 0)`` and ``G = dbn * scale``."""
    gf, hhat, bn = _bn_rebuild(g, h1, mean, inv, bn_scale, bn_bias)
    dbn = (gf @ w2.to(gf.dtype).t()) * (bn > 0)
    return gf, hhat, bn, dbn, dbn * bn_scale


def bn_backward_sums_plain(g, h1, w2, vec4):
    """Plain twin of :func:`bn_backward_sums` on its operands: ``[4, 2D]``
    = ``Sg``, ``Sgh``, ``dscale``, ``dbias`` over all rows."""
    _, hhat, _, dbn, big_g = _bn_backward_rows(g, h1, w2, *vec4)
    return torch.stack([big_g.sum(0), (big_g * hhat).sum(0),
                        (dbn * hhat).sum(0), dbn.sum(0)])


def dw2_db2_reference(g, h1, vec4):
    """Plain twin of :func:`dw2_db2`: ``(relu(bn(h1))^T g, column sums of
    g)`` over all rows, ``bn`` rebuilt from ``vec4`` (mean, inv, scale,
    bias)."""
    gf, _, bn = _bn_rebuild(g, h1, *vec4)
    return torch.relu(bn).t() @ gf, gf.sum(0)


def bn_backward_sums_reference(g, h1, w2, mean, var, bn_scale, bn_bias):
    """Plain twin of the bwd1 kernels: ``(Sg, Sgh, dw2, db2, dscale,
    dbias)`` for the cotangent ``g [B, N, D]`` of ``y`` and the stored
    ``h1 [B, N, 2D]``, every sum over ALL rows (``_tl_bwd1_kernel``): the
    four sums of :func:`bn_backward_sums_plain` and
    :func:`dw2_db2_reference`."""
    vec4 = (mean, torch.rsqrt(var + BN_EPS), bn_scale, bn_bias)
    sg, sgh, dscale, dbias = bn_backward_sums_plain(g, h1, w2, vec4)
    return (sg, sgh, *dw2_db2_reference(g, h1, vec4), dscale, dbias)


def dh1_reference(g, h1, w2, vec6, row_mask):
    """Plain twin of :func:`dh1_kernel`: ``dh1 [R, 2D] = inv * (G - (c1 +
    hhat * c2) * rowmask)``, ``row_mask`` uint8 ``[R]`` or None."""
    mean, inv, scale, bias, c1, c2 = vec6
    _, hhat, _, _, big_g = _bn_backward_rows(g, h1, w2, mean, inv, scale,
                                             bias)
    corr = c1 + hhat * c2
    if row_mask is not None:
        corr = corr * row_mask.reshape(-1, 1).to(corr.dtype)
    return inv * (big_g - corr)


def _row_plan(r: int, tile: int, max_blocks: int):
    """``(rows, blocks)``: ``r`` rows cut into at most ``max_blocks`` blocks
    of whole ``tile``-row tiles, block ``z`` covering rows ``[z * rows,
    min(r, (z + 1) * rows))``: every row once, no block empty."""
    tiles = -(-r // tile)
    rows = -(-tiles // max_blocks) * tile
    return rows, -(-r // rows)


def check_row_plan(what: str, r: int, rows: int, blocks: int, tile: int):
    """Raise unless the plan covers each of ``r`` rows once, in whole
    ``tile``-row tiles, with no block empty (the C entries' ``row_plan_ok``,
    which refuse the same plans)."""
    if not (rows > 0 and rows % tile == 0 and 0 < blocks <= 65535
            and rows * blocks >= r and rows * (blocks - 1) < r):
        raise ValueError(f"{what} row plan of {blocks} blocks x {rows} rows "
                         f"does not cover {r} rows once in whole {tile}-row "
                         f"tiles")


def h1_plan(r: int):
    """``(rows_per_block, blocks)`` of :func:`h1_stats`: the 2D columns go
    to two blocks (each keeps its half of ``w1`` resident at D = 128), so
    at most ``NUM_SMS // 2`` row blocks of whole 128-row tiles, one block an
    SM."""
    rows, blocks = _row_plan(r, H1_TILE_ROWS, NUM_SMS // 2)
    check_row_plan("h1", r, rows, blocks, H1_TILE_ROWS)
    return rows, blocks


def fwd2_plan(r: int):
    """``(rows_per_block, blocks)`` of :func:`bn_relu_conv2`: ``w2``'s D =
    128 columns are one column block, so at most ``NUM_SMS`` row blocks of
    whole 128-row tiles, one block an SM."""
    rows, blocks = _row_plan(r, FWD2_TILE_ROWS, NUM_SMS)
    check_row_plan("fwd2", r, rows, blocks, FWD2_TILE_ROWS)
    return rows, blocks


def dh2_plan(r: int):
    """``(rows_per_block, blocks)`` of the two dh2 launches
    (``tl_dh2_kernel``): one block an SM at most, each a whole number of
    64-row tiles, block ``z`` covering rows ``[z * rows_per_block, min(r,
    (z + 1) * rows_per_block))``: every row once, no block empty."""
    rows, blocks = _row_plan(r, DH2_TILE_ROWS, NUM_SMS)
    check_row_plan("dh2", r, rows, blocks, DH2_TILE_ROWS)
    return rows, blocks


def dw2_plan(r: int, d: int):
    """``(rows_per_split, splits)`` of :func:`dw2_db2`: the A^T product's
    plan (``layer.tn_plan``) for its ``[2D, D]`` output, about one block an
    SM over the 128 x 128 output tiles, each split whole ring stages."""
    rows, splits = tn_plan(r, 2 * d, d)
    check_row_plan("dw2", r, rows, splits, TN_STAGE_ROWS)
    return rows, splits


# ---------------------------------------------------------------------------
# launch wrappers of csrc/train_layer.cu (CUDA tensors; each takes its plain
# twin on CPU tensors)
# ---------------------------------------------------------------------------

def _launch(name, ref, *args):
    with torch.cuda.device(ref.device):
        stream = torch.cuda.current_stream(ref.device).cuda_stream
        library().call(name, *args, stream)


def _rows(t):
    return t.numel() // t.shape[-1]


def _row_mask(valid_mask):
    """uint8 ``[B*N]`` for the kernels, or None (every row valid)."""
    return (None if valid_mask is None
            else valid_mask.to(torch.uint8).contiguous())


def _require_cuda(*tensors):
    for t in tensors:
        if t is not None and not (t.device.type == "cuda" and t.is_contiguous()
                                  and t.device == tensors[0].device):
            raise ValueError("train-layer kernels take contiguous CUDA "
                             "tensors on one device")


def h1_stats(x, msg, w1, b1, row_mask):
    """``(h1 [R, 2D] in x's dtype, sums [2, 2D] float32)``: ``cat(x, msg) @
    w1 + b1`` and the column sums of ``h1 * rowmask`` and ``h1^2 * rowmask``
    taken before the rounding to ``x``'s dtype. ``x [.., D]``, ``msg [R, D]``
    float32, ``row_mask`` uint8 ``[R]`` or None. The rows are split by
    :func:`h1_plan`. A CPU tensor takes :func:`h1_stats_reference`."""
    if x.device.type == "cpu":
        return h1_stats_reference(x, msg, w1, b1, row_mask)
    _require_cuda(x, msg, w1, b1, row_mask)
    d, r = x.shape[-1], _rows(x)
    if (x.dtype not in DTYPE_CODES or msg.dtype != torch.float32
            or msg.numel() != r * d or w1.shape != (2 * d, 2 * d)
            or b1.shape != (2 * d,)
            or any(t.dtype != torch.float32 for t in (w1, b1))
            or (row_mask is not None and row_mask.numel() != r)):
        raise ValueError("h1_stats kernel: operand dtypes or shapes")
    rows, blocks = h1_plan(r)
    f32, dev = torch.float32, x.device
    h1 = torch.empty((r, 2 * d), dtype=x.dtype, device=dev)
    partial = torch.empty((blocks, 2, 2 * d), dtype=f32, device=dev)
    sums = torch.empty((2, 2 * d), dtype=f32, device=dev)
    _launch("mdgat_tl_h1", x, x.data_ptr(), msg.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), _ptr(row_mask), h1.data_ptr(), partial.data_ptr(),
            partial.numel(), sums.data_ptr(), d, r, rows, blocks,
            DTYPE_CODES[x.dtype])
    h1_stats.launches += 1
    return h1, sums


h1_stats.launches = 0


def bn_relu_conv2(x, h1, a, c, w2, b2):
    """``y = x + relu(h1 * a + c) @ w2 + b2`` in x's dtype and shape; ``h1
    [R, 2D]`` in x's dtype, ``a``, ``c [2D]``, ``w2 [2D, D]``, ``b2 [D]``
    float32. The rows are split by :func:`fwd2_plan`. A CPU tensor takes
    :func:`bn_relu_conv2_reference`."""
    if x.device.type == "cpu":
        return bn_relu_conv2_reference(x, h1, a, c, w2, b2)
    _require_cuda(x, h1, a, c, w2, b2)
    d, r = x.shape[-1], _rows(x)
    if (x.dtype not in DTYPE_CODES or h1.dtype != x.dtype
            or h1.numel() != r * 2 * d or w2.shape != (2 * d, d)
            or a.shape != (2 * d,) or c.shape != (2 * d,) or b2.shape != (d,)
            or any(t.dtype != torch.float32 for t in (a, c, w2, b2))):
        raise ValueError("bn_relu_conv2 kernel: operand dtypes or shapes")
    rows, blocks = fwd2_plan(r)
    y = torch.empty_like(x)
    _launch("mdgat_tl_fwd2", x, x.data_ptr(), h1.data_ptr(), a.data_ptr(),
            c.data_ptr(), w2.data_ptr(), b2.data_ptr(), y.data_ptr(), d, r,
            rows, blocks, DTYPE_CODES[x.dtype])
    bn_relu_conv2.launches += 1
    return y


bn_relu_conv2.launches = 0


def _check_backward_operands(what, g, h1, w2, vec, vec_rows):
    _require_cuda(g, h1, w2, vec)
    d, r = g.shape[-1], _rows(g)
    if (g.dtype not in DTYPE_CODES or h1.dtype != g.dtype
            or h1.numel() != r * 2 * d or w2.shape != (2 * d, d)
            or vec.shape != (vec_rows, 2 * d)
            or any(t.dtype != torch.float32 for t in (w2, vec))):
        raise ValueError(f"{what} kernel: operand dtypes or shapes")
    return d, r


def bn_backward_sums(g, h1, w2, vec4):
    """``[4, 2D]`` float32: ``Sg``, ``Sgh``, ``dscale``, ``dbias`` over all
    rows of ``g [.., D]`` and ``h1 [R, 2D]`` (one dtype); ``vec4 [4, 2D]``
    holds mean, inv, scale, bias. The rows are split by :func:`dh2_plan`.
    A CPU tensor takes :func:`bn_backward_sums_plain`."""
    if g.device.type == "cpu":
        return bn_backward_sums_plain(g, h1, w2, vec4)
    d, r = _check_backward_operands("bn_backward_sums", g, h1, w2, vec4, 4)
    rows, blocks = dh2_plan(r)
    f32, dev = torch.float32, g.device
    partial = torch.empty((blocks, 4, 2 * d), dtype=f32, device=dev)
    sums = torch.empty((4, 2 * d), dtype=f32, device=dev)
    _launch("mdgat_tl_bwd_sums", g, g.data_ptr(), h1.data_ptr(),
            w2.data_ptr(), vec4.data_ptr(), partial.data_ptr(),
            partial.numel(), sums.data_ptr(), d, r, rows, blocks,
            DTYPE_CODES[g.dtype])
    bn_backward_sums.launches += 1
    return sums


bn_backward_sums.launches = 0


def dw2_db2(g, h1, vec4):
    """``(dw2 [2D, D], db2 [D])`` float32: ``relu(bn(h1))^T g`` and the
    column sums of ``g`` over all rows of ``g [.., D]`` and ``h1 [R, 2D]``
    (one dtype), ``bn`` rebuilt from ``vec4 [4, 2D]`` (mean, inv, scale,
    bias); the rows split by :func:`dw2_plan` and added in a fixed order. A
    CPU tensor takes :func:`dw2_db2_reference`."""
    if g.device.type == "cpu":
        return dw2_db2_reference(g, h1, vec4)
    _require_cuda(g, h1, vec4)
    d, r = g.shape[-1], _rows(g)
    if (g.dtype not in DTYPE_CODES or h1.dtype != g.dtype
            or h1.numel() != r * 2 * d or vec4.shape != (4, 2 * d)
            or vec4.dtype != torch.float32):
        raise ValueError("dw2_db2 kernel: operand dtypes or shapes")
    rows, splits = dw2_plan(r, d)
    f32, dev = torch.float32, g.device
    partial = torch.empty((splits, 2 * d + 1, d), dtype=f32, device=dev)
    out = torch.empty((2 * d + 1, d), dtype=f32, device=dev)
    _launch("mdgat_tl_dw2", g, h1.data_ptr(), vec4.data_ptr(), g.data_ptr(),
            partial.data_ptr(), partial.numel(), out.data_ptr(), d, r, rows,
            splits, DTYPE_CODES[g.dtype])
    dw2_db2.launches += 1
    return out[:2 * d], out[2 * d]


dw2_db2.launches = 0


def dh1_kernel(g, h1, w2, vec6, row_mask):
    """``dh1 [R, 2D]`` float32 ``= inv * (G - (c1 + hhat * c2) * rowmask)``
    with ``G = (g @ w2^T) * (bn > 0) * scale``; ``vec6 [6, 2D]`` holds mean,
    inv, scale, bias, ``Sg / cnt``, ``Sgh / cnt``; the rows are split by
    :func:`dh2_plan`. A CPU tensor takes :func:`dh1_reference`."""
    if g.device.type == "cpu":
        return dh1_reference(g, h1, w2, vec6, row_mask)
    d, r = _check_backward_operands("dh1", g, h1, w2, vec6, 6)
    rows, blocks = dh2_plan(r)
    _require_cuda(g, row_mask)
    if row_mask is not None and row_mask.numel() != r:
        raise ValueError("dh1 kernel: row mask shape")
    dh1 = torch.empty((r, 2 * d), dtype=torch.float32, device=g.device)
    _launch("mdgat_tl_dh1", g, g.data_ptr(), h1.data_ptr(), w2.data_ptr(),
            vec6.data_ptr(), _ptr(row_mask), dh1.data_ptr(), d, r, rows,
            blocks, DTYPE_CODES[g.dtype])
    dh1_kernel.launches += 1
    return dh1


dh1_kernel.launches = 0


# ---------------------------------------------------------------------------
# the layer: launch helpers, autograd Function, entries
# ---------------------------------------------------------------------------

def _tl_fwd1(x, source, kv_mask, valid_mask, topk, h, wq, bq, wk, bk, wv, bv,
             wm, bm, w1, b1):
    """The launches that stand for ``_tl_fwd1_kernel``: ``(h1 [B*N, 2D],
    thr, lse, sums [2, 2D])``, sums = the masked ``ssum`` and ``ssq``."""
    # the launches of the fused-MHA forward, by the same kernels: thr and
    # lse carry its bits
    o, thr, lse = mha._project_attend(x, source, kv_mask, topk, h, wq, bq, wk,
                                      bk, wv, bv)
    msg = gemm(o, wm, bm, a1_heads=h, rows_per_batch=x.shape[1],
               out_dtype=torch.float32)
    h1, sums = h1_stats(x, msg, w1, b1, _row_mask(valid_mask))
    return h1, thr, lse, sums


def _tl_forward(x, source, kv_mask, valid_mask, topk, h, wq, bq, wk, bk, wv,
                bv, wm, bm, w1, b1, w2, b2, bn_scale, bn_bias, group=None):
    """The forward launches: ``(y, mean, var, cnt, h1, thr, lse, sums)``;
    ``sums`` are this rank's, the statistics and ``cnt`` those of the ranks
    of ``group`` (this rank alone when it is None)."""
    h1, thr, lse, sums = _tl_fwd1(x, source, kv_mask, valid_mask, topk, h, wq,
                                  bq, wk, bk, wv, bv, wm, bm, w1, b1)
    (ssum, ssq), cnt = _global_sums(
        sums, _row_count(x, valid_mask, torch.float32), group)
    mean, var = _batch_stats(ssum, ssq, cnt)
    var = var.clamp_min(0.0)
    a = bn_scale * torch.rsqrt(var + BN_EPS)
    y = bn_relu_conv2(x, h1, a, bn_bias - mean * a, w2, b2)
    fused_train_layer.forward_launches += 1
    return y, mean, var, cnt, h1, thr, lse, sums


def _tl_bwd1(g, h1, w2, vec4):
    """The launches that stand for ``_tl_bwd1_kernel``: ``(sums [4, 2D] =
    Sg, Sgh, dscale, dbias; dw2; db2)``, every sum over ALL rows, padded
    ones included."""
    return (bn_backward_sums(g, h1, w2, vec4), *dw2_db2(g, h1, vec4))


def _tl_bwd2(x, source, kv_mask, valid_mask, thr, lse, h1, g, vec6, h, wq, bq,
             wk, bk, wv, bv, wm, bm, w1, w2):
    """The launches that stand for ``_tl_bwd2_kernel``: ``(dx, dsrc, dwq,
    dbq, dwk, dbk, dwv, dbv, dwm, dbm, dw1, db1)``."""
    b, n, d = x.shape
    f32 = torch.float32
    # the row mask enters here, as the factor on the centering correction
    dh1 = dh1_kernel(g, h1, w2, vec6, _row_mask(valid_mask))
    dmsg = gemm(dh1, w1[d:], None, w_trans=True)                # dh1 @ w1m^T
    g32 = g.reshape(b * n, d).to(f32)
    dx_res = gemm(dh1, w1[:d], None, w_trans=True, res=g32)     # g + dx_mlp
    # q and k again by the forward's kernels, so s >= thr keeps the
    # forward's entries; dx = g + dx_mlp + dx_attn in the last epilogue
    (dx, dsrc, dwq, dbq, dwk, dbk, dwv, dbv, dwm, dbm,
     o) = mha._mha_backward_launches(x, source, kv_mask, thr, lse, dmsg, h,
                                     wq, bq, wk, bk, wv, bv, wm,
                                     dx_res=dx_res)
    msg = gemm(o, wm, bm)
    dw1x, db1 = gemm_tn(x.reshape(b * n, d).to(f32), dh1)
    dw1m, _ = gemm_tn(msg, dh1)
    return (dx.to(x.dtype), dsrc, dwq, dbq, dwk, dbk, dwv, dbv, dwm, dbm,
            torch.cat([dw1x, dw1m]), db1)


def _tl_backward(x, source, kv_mask, valid_mask, thr, lse, h1, mean, var, cnt,
                 g, h, wq, bq, wk, bk, wv, bv, wm, bm, w1, w2, bn_scale,
                 bn_bias, group=None):
    """The backward launches: ``(dx, dsrc, dwq, dbq, dwk, dbk, dwv, dbv, dwm,
    dbm, dw1, db1, dw2, db2, dscale, dbias)``; the weight gradients are
    float32, blocked as the weights came in. With ``group``, ``Sg`` and
    ``Sgh`` are summed over its ranks (every rank's rows were normalised
    with the global statistics); ``cnt`` is already global."""
    g = g.to(x.dtype).contiguous()
    vec4 = torch.stack([mean, torch.rsqrt(var + BN_EPS), bn_scale, bn_bias])
    sums, dw2, db2 = _tl_bwd1(g, h1, w2, vec4)
    sg_sgh = sums[:2]
    if group is not None:
        sg_sgh = all_reduce(sg_sgh.contiguous(), group, "layer_bn_backward")
    vec6 = torch.cat([vec4, sg_sgh / cnt])
    grads = _tl_bwd2(x, source, kv_mask, valid_mask, thr, lse, h1, g, vec6, h,
                     wq, bq, wk, bk, wv, bv, wm, bm, w1, w2)
    fused_train_layer.backward_launches += 1
    return grads + (dw2, db2, sums[2], sums[3])


class _FusedTrainLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, source, kv_mask, valid_mask, topk, num_heads,
                *weights):
        # the group of this forward, kept for the backward: autograd runs it
        # on its own thread, outside the forward's bn_cross_replica context
        ctx.group = bn_group()
        y, mean, var, cnt, h1, thr, lse, _ = _tl_forward(
            x, source, kv_mask, valid_mask, topk, num_heads, *weights,
            group=ctx.group)
        wq, bq, wk, bk, wv, bv, wm, bm, w1, _, w2, _, scale, bias = weights
        ctx.save_for_backward(x, source, thr, lse, h1, mean, var, cnt, wq, bq,
                              wk, bk, wv, bv, wm, bm, w1, w2, scale, bias)
        ctx.masks, ctx.num_heads = (kv_mask, valid_mask), num_heads
        ctx.mark_non_differentiable(mean, var, cnt)
        return y, mean, var, cnt

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var, _g_cnt):
        x, source, thr, lse, h1, mean, var, cnt, *weights = ctx.saved_tensors
        grads = _tl_backward(x, source, *ctx.masks, thr, lse, h1, mean, var,
                             cnt, g, ctx.num_heads, *weights, group=ctx.group)
        return (grads[0], grads[1], None, None, None, None) + grads[2:]


def _check_inputs(x, source, kv_mask, valid_mask, num_heads, weights):
    mha._check_inputs(x, source, kv_mask, num_heads, weights[:8])
    b, n, d = x.shape
    if valid_mask is not None and valid_mask.shape != (b, n):
        raise ValueError("train-layer kernels: valid_mask must be [B, N]")
    shapes = ((2 * d, 2 * d), (2 * d,), (2 * d, d), (d,), (2 * d,), (2 * d,))
    for w, shape in zip(weights[8:], shapes):
        if (w.shape != shape or w.dtype != torch.float32
                or w.device != x.device):
            raise ValueError("train-layer kernels: MLP and BatchNorm "
                             "operands must be float32 [2D, 2D], [2D], "
                             "[2D, D], [D], [2D], [2D] on the input's device")


def fused_train_layer(x, source, kv_mask: Optional[torch.Tensor],
                      valid_mask: Optional[torch.Tensor],
                      topk: Optional[int], num_heads: int, *weights):
    """``(y, batch_mean, batch_var)`` of one training layer: ``x [B, N, D]``
    attending to ``source [B, M, D]`` under the key mask ``[B, M]``, the
    batch statistics over the rows ``valid_mask [B, N]`` marks, on the
    operands of :func:`train_layer_weights`; ``topk`` None or 0 is dense.
    ``y`` includes the residual and is differentiable in x, source and the
    fourteen operands; the mean and the biased variance ``[2D]`` feed the
    running statistics and carry no gradient. Under ``bn_cross_replica``
    the statistics are the group's."""
    return _train_layer(x, source, kv_mask, valid_mask, topk, num_heads,
                        *weights)[:3]


def _train_layer(x, source, kv_mask, valid_mask, topk, num_heads, *weights):
    """:func:`fused_train_layer`'s outputs and the row count of the
    statistics, floored at 1."""
    if x.device.type == "cpu":
        return _reference(x, source, kv_mask, valid_mask, topk, num_heads,
                          *weights)[:4]
    weights = tuple(w.contiguous() for w in weights)
    _check_inputs(x, source, kv_mask, valid_mask, num_heads, weights)
    return _FusedTrainLayer.apply(x.contiguous(), source.contiguous(),
                                  kv_mask, valid_mask, topk, num_heads,
                                  *weights)


def fused_train_layer_forward(x, source, kv_mask, valid_mask, topk, num_heads,
                              *weights):
    """``(y, mean, var, h1, thr, lse, ssum, ssq)`` of the forward alone, no
    autograd (``_tl_fwd_calls`` of the JAX package): the outputs and what
    the backward is given."""
    if x.device.type == "cpu":
        with torch.no_grad():
            return fused_train_layer_reference(
                x, source, kv_mask, valid_mask, topk, num_heads, *weights,
                return_residuals=True)
    weights = tuple(w.detach().contiguous() for w in weights)
    _check_inputs(x, source, kv_mask, valid_mask, num_heads, weights)
    with torch.no_grad():
        y, mean, var, _, h1, thr, lse, sums = _tl_forward(
            x.contiguous(), source.contiguous(), kv_mask, valid_mask, topk,
            num_heads, *weights)
    return (y, mean, var, h1.reshape(*x.shape[:2], -1), thr, lse, sums[0],
            sums[1])


# whole-layer passes, counted beside the launches of the new kernels (the
# forward's h1_stats and bn_relu_conv2, the backward's bn_backward_sums,
# dw2_db2 and dh1_kernel); fused_mha's own counters stay still on this route
fused_train_layer.forward_launches = 0
fused_train_layer.backward_launches = 0


def fused_train_layer_apply(layer, x, source, topk: Optional[int],
                            kv_mask: Optional[torch.Tensor] = None,
                            valid_mask: Optional[torch.Tensor] = None):
    """Training-mode entry for an ``AttentionalPropagation``: ``y = x +
    delta`` from :func:`fused_train_layer`, and the layer's BatchNorm
    running statistics moved in place (momentum ``BN_MOMENTUM``, the
    single-pass variance unbiased by ``cnt / max(cnt - 1, 1)``,
    ``num_batches_tracked`` ticked); ``cnt`` is the global row count under
    ``bn_cross_replica``."""
    y, mean, var, cnt = _train_layer(x, source, kv_mask, valid_mask, topk,
                                     layer.num_heads,
                                     *train_layer_weights(layer))
    bn = layer.mlp[1]
    with torch.no_grad():
        cnt = cnt.to(mean.dtype)
        unbiased = var * (cnt / (cnt - 1.0).clamp_min(1.0))
        rdt = bn.running_mean.dtype
        bn.running_mean.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mean.to(rdt))
        bn.running_var.mul_(1 - BN_MOMENTUM).add_(
            BN_MOMENTUM * unbiased.to(rdt))
        bn.num_batches_tracked += 1
    return y
