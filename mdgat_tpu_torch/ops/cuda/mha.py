"""Fused multi-head attention for training: ``merge(MHA(x, source))`` with
a hand-written forward and backward, and its plain twin.

Replaces ``mdgat_tpu/ops/pallas/attention.py::fused_mha`` (a custom VJP
over ``_mha_fwd_call`` / ``_mha_fwd_kernel`` and ``_mha_bwd_call`` /
``_mha_bwd_kernel`` / ``_mha_bwd_block``). As there, the weights are
head-blocked (:func:`blocked_weights`: q/k/v columns and merge rows
permuted from the torch channel interleave ``c = d*H + h`` to ``h*Dh + d``,
the ``1/sqrt(Dh)`` score scale folded into wq / bq), so heads are
contiguous column blocks and no activation is ever relaid out. The blocking
is plain differentiable tensor code: autograd carries the blocked
gradients the kernels return back to the ``Conv1x1`` parameters, which
undoes the permutation and applies the fold's factor.

Forward (five launches): the q, k, v projections on ``csrc/gemm.cu`` with
the head-split epilogue, ``csrc/attention.cu`` with its ``lse`` output, and
the merge GEMM. The residuals are the inputs plus the per-row threshold
``thr`` and logsumexp ``lse`` ``[B, H, N, 1]``, as on the TPU.

Backward (fifteen launches): q, k, v again by the same GEMM kernel (so the
recomputed scores carry the forward's bits and ``s >= thr`` keeps the same
entries), ``do = g @ wm^T``, the two attention-backward kernels of
``csrc/mha_bwd.cu`` (o, dq; then dk, dv), ``dx = dq @ wq^T``,
``dsrc = cat(dk, dv) @ cat(wk, wv)^T``, and four transposed-A split-K
GEMMs for the weight and bias gradients (``x^T dq``, ``src^T dk``,
``src^T dv``, ``o^T g``), each with a fixed-order second-stage reduce: the
step is deterministic, no atomics. No ``torch.matmul``, cuBLAS or SDPA runs
in either direction. Gradients of the weights are float32; dx and dsrc take
the input dtype. With ``source is x`` (self-attention) the function
returns both gradients and autograd adds them.

A CUDA tensor launches the kernels; a CPU tensor takes
:func:`fused_mha_reference` under autograd. Nothing falls back: a CUDA call
the kernels cannot take raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from mdgat_tpu_torch.ops.attention import acc_dtype, attention_core
from mdgat_tpu_torch.ops.cuda import attention as attn_kernel
from mdgat_tpu_torch.ops.cuda._build import DTYPE_CODES, library
from mdgat_tpu_torch.ops.cuda.layer import gemm, gemm_tn


def blocked_weights(attn, num_heads: int):
    """``(wq, bq, wk, bk, wv, bv, wm, bm)`` of a ``MultiHeadedAttention``
    module: dense ``[in, out]`` matrices in the accumulation dtype,
    head-blocked, the score scale folded into wq / bq (``_blocked_proj`` /
    ``_blocked_merge`` of the JAX package). Differentiable."""
    d = attn.merge.weight.shape[0]
    dh = d // num_heads
    dt = acc_dtype(attn.merge.weight.dtype)

    def proj(conv, fold=None):
        w = conv.weight[:, :, 0].t().to(dt)            # [in, out], c = d*H + h
        w = w.reshape(d, dh, num_heads).permute(0, 2, 1).reshape(d, d)
        b = conv.bias.to(dt).reshape(dh, num_heads).t().reshape(d)
        if fold is not None:
            w, b = w * fold, b * fold
        return w.contiguous(), b.contiguous()

    wq, bq = proj(attn.proj[0], 1.0 / dh ** 0.5)
    wk, bk = proj(attn.proj[1])
    wv, bv = proj(attn.proj[2])
    wm = attn.merge.weight[:, :, 0].t().to(dt)         # rows r = d*H + h
    wm = wm.reshape(dh, num_heads, d).permute(1, 0, 2).reshape(d, d)
    return wq, bq, wk, bk, wv, bv, wm.contiguous(), attn.merge.bias.to(dt)


def _split_blocked(t: torch.Tensor, h: int) -> torch.Tensor:
    """[B, N, D] head-blocked columns -> [B, H, N, Dh]."""
    b, n, d = t.shape
    return t.reshape(b, n, h, d // h).permute(0, 2, 1, 3)


def fused_mha_reference(x, source, kv_mask: Optional[torch.Tensor],
                        topk: Optional[int], num_heads: int, wq, bq, wk, bk,
                        wv, bv, wm, bm, return_residuals: bool = False):
    """Plain PyTorch twin of :func:`fused_mha` on the same blocked weights:
    the same order of operations, differentiable by autograd with the
    selection frozen (see ``ops/attention.py::attention_core``). Returns
    the output ``[B, N, D]`` in ``x``'s dtype and, with
    ``return_residuals``, ``thr`` and ``lse`` ``[B, H, N, 1]``."""
    acc = acc_dtype(x.dtype)
    cast = lambda t: t.to(acc)
    xf, sf = cast(x), cast(source)
    q = _split_blocked(xf @ cast(wq) + cast(bq), num_heads)
    k = _split_blocked(sf @ cast(wk) + cast(bk), num_heads)
    v = _split_blocked(sf @ cast(wv) + cast(bv), num_heads)
    s = torch.matmul(q, k.transpose(-1, -2))          # scale folded into wq
    o, thr, lse = attention_core(s, v, kv_mask, topk, return_lse=True)
    out = (o.permute(0, 2, 1, 3).reshape(x.shape) @ cast(wm)
           + cast(bm)).to(x.dtype)
    if return_residuals:
        return out, thr.to(acc), lse.to(acc)
    return out


def _check_inputs(x, source, kv_mask, num_heads, weights):
    if x.device.type != "cuda":
        raise ValueError(f"no fused-MHA kernel for device {x.device}")
    b, n, d = x.shape
    m = source.shape[1]
    if (x.dtype not in DTYPE_CODES or source.dtype != x.dtype
            or source.shape != (b, m, d) or d % num_heads):
        raise ValueError("fused-MHA kernel: x [B, N, D] and source [B, M, D] "
                         "in one dtype (float32 / bfloat16), D a multiple of "
                         "the head count")
    if kv_mask is not None and kv_mask.shape != (b, m):
        raise ValueError("fused-MHA kernel: mask must be [B, M]")
    for i, w in enumerate(weights):
        shape = (d, d) if i % 2 == 0 else (d,)
        if (w.shape != shape or w.dtype != torch.float32
                or w.device != x.device):
            raise ValueError("fused-MHA kernel: weights must be float32 "
                             "[D, D] / [D] on the input's device")


def _mha_forward(x, source, kv_mask, topk, h, wq, bq, wk, bk, wv, bv, wm, bm):
    """The forward launches: (out [B, N, D], thr, lse [B, H, N, 1])."""
    b, n, d = x.shape
    m = source.shape[1]
    f32 = torch.float32
    q = gemm(x, wq, bq, out_dtype=f32, out_heads=h, rows_per_batch=n)
    k = gemm(source, wk, bk, out_dtype=f32, out_heads=h, rows_per_batch=m)
    v = gemm(source, wv, bv, out_dtype=f32, out_heads=h, rows_per_batch=m)
    o, thr, lse = attn_kernel.topk_attention(q, k, v, kv_mask, int(topk or 0),
                                             1.0, return_lse=True)
    fused_mha.forward_launches += 1
    out = gemm(o, wm, bm, a1_heads=h, rows_per_batch=n, out_dtype=x.dtype)
    return out.reshape(b, n, d), thr, lse


def _attention_backward(q, k, v, do, kv_mask, thr, lse):
    """The two launches of ``csrc/mha_bwd.cu`` on head-split q, do
    ``[B, H, N, Dh]`` and k, v ``[B, H, M, Dh]``: (o, dq) ``[B*N, D]`` and
    (dk, dv) ``[B*M, D]`` with head-blocked columns."""
    b, h, n, dh = q.shape
    m = k.shape[2]
    dev, f32 = q.device, torch.float32
    if kv_mask is None:
        mask = torch.ones((b, m), dtype=torch.uint8, device=dev)
    else:
        mask = kv_mask.to(torch.uint8).contiguous()
    o_full = torch.empty((b * n, h * dh), dtype=f32, device=dev)
    dq = torch.empty((b * n, h * dh), dtype=f32, device=dev)
    dk = torch.empty((b * m, h * dh), dtype=f32, device=dev)
    dv = torch.empty((b * m, h * dh), dtype=f32, device=dev)
    delta = torch.empty((b, h, n), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        library().call("mdgat_mha_attention_bwd", q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), do.data_ptr(), mask.data_ptr(),
                       thr.data_ptr(), lse.data_ptr(), o_full.data_ptr(),
                       dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                       delta.data_ptr(), b, h, n, m, dh, stream)
    fused_mha.backward_launches += 1
    return o_full, dq, dk, dv


def _mha_backward(x, source, kv_mask, thr, lse, g, h, wq, bq, wk, bk, wv, bv,
                  wm):
    """The backward launches: (dx, dsrc, dwq, dbq, dwk, dbk, dwv, dbv, dwm,
    dbm), weights blocked as they came in."""
    b, n, d = x.shape
    m = source.shape[1]
    f32 = torch.float32
    # the forward's projections again, by the same kernel: same bits
    q = gemm(x, wq, bq, out_dtype=f32, out_heads=h, rows_per_batch=n)
    k = gemm(source, wk, bk, out_dtype=f32, out_heads=h, rows_per_batch=m)
    v = gemm(source, wv, bv, out_dtype=f32, out_heads=h, rows_per_batch=m)
    do = gemm(g, wm, None, out_dtype=f32, out_heads=h, rows_per_batch=n,
              w_trans=True)                                  # g @ wm^T
    o_full, dq, dk, dv = _attention_backward(q, k, v, do, kv_mask, thr, lse)
    dx = gemm(dq, wq, None, out_dtype=x.dtype, w_trans=True)
    dsrc = gemm(dk, torch.cat([wk, wv], dim=1), None, a2=dv,
                out_dtype=source.dtype, w_trans=True)
    x2 = x.reshape(b * n, d).to(f32)
    s2 = source.reshape(b * m, d).to(f32)
    dwq, dbq = gemm_tn(x2, dq)
    dwk, dbk = gemm_tn(s2, dk)
    dwv, dbv = gemm_tn(s2, dv)
    dwm, dbm = gemm_tn(o_full, g.reshape(b * n, d).to(f32))
    return (dx.reshape(b, n, d), dsrc.reshape(b, m, d), dwq, dbq, dwk, dbk,
            dwv, dbv, dwm, dbm)


class _FusedMHA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, source, kv_mask, topk, num_heads, *weights):
        out, thr, lse = _mha_forward(x, source, kv_mask, topk, num_heads,
                                     *weights)
        ctx.save_for_backward(x, source, thr, lse, *weights[:7])
        ctx.kv_mask, ctx.num_heads = kv_mask, num_heads
        return out

    @staticmethod
    def backward(ctx, g):
        x, source, thr, lse, *weights = ctx.saved_tensors
        grads = _mha_backward(x, source, ctx.kv_mask, thr, lse,
                              g.contiguous(), ctx.num_heads, *weights)
        return (grads[0], grads[1], None, None, None) + grads[2:]


def fused_mha(x, source, kv_mask: Optional[torch.Tensor],
              topk: Optional[int], num_heads: int, wq, bq, wk, bk, wv, bv,
              wm, bm):
    """``merge(MHA(x, source))`` ``[B, N, D]`` for ``x [B, N, D]`` attending
    to ``source [B, M, D]`` under the key mask ``[B, M]``, on the blocked
    weights of :func:`blocked_weights`; ``topk`` None or 0 is dense.
    Differentiable in x, source and the weights."""
    if x.device.type == "cpu":
        return fused_mha_reference(x, source, kv_mask, topk, num_heads, wq,
                                   bq, wk, bk, wv, bv, wm, bm)
    weights = tuple(w.contiguous() for w in (wq, bq, wk, bk, wv, bv, wm, bm))
    _check_inputs(x, source, kv_mask, num_heads, weights)
    return _FusedMHA.apply(x.contiguous(), source.contiguous(), kv_mask,
                           topk, num_heads, *weights)


def fused_mha_forward(x, source, kv_mask, topk, num_heads, *weights):
    """``(out, thr, lse)`` of the forward alone, no autograd
    (``_mha_fwd_call`` of the JAX package): the output and the residuals
    the backward is given."""
    if x.device.type == "cpu":
        with torch.no_grad():
            return fused_mha_reference(x, source, kv_mask, topk, num_heads,
                                       *weights, return_residuals=True)
    weights = tuple(w.detach().contiguous() for w in weights)
    _check_inputs(x, source, kv_mask, num_heads, weights)
    with torch.no_grad():
        return _mha_forward(x.contiguous(), source.contiguous(), kv_mask,
                            topk, num_heads, *weights)


# counted where the attention kernel with its lse output (the forward) and
# the two kernels of csrc/mha_bwd.cu (the backward) are launched
fused_mha.forward_launches = 0
fused_mha.backward_launches = 0
