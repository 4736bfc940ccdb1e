"""Whole eval attentional-propagation layer on hand-written kernels.

Replaces ``mdgat_tpu/ops/pallas/attention.py::fused_layer_apply`` /
``_layer_kernel``: ``x + relu(x @ w1x + merge(MHA(x, src)) @ w1m + b1) @ w2
+ b2``, with eval BatchNorm folded into ``w1`` / ``b1``. The layer is seven
launches: six of the tiled GEMM of ``csrc/gemm.cu`` (q, k, v projections
written straight into the attention layout; the head merge read straight
from it; the first MLP conv with ReLU over two A operands, which avoids the
concat; the second MLP conv with the residual) and one of the attention
kernel of ``csrc/attention.cu``. No ``torch.matmul``, cuBLAS or SDPA runs
on this path. Intermediates are float32 and round-trip through HBM between
launches (the TPU kernel kept them in VMEM); fusing the layer into one
kernel is later work.

Weight preparation (:func:`prepare_layer_weights`) runs on the host once
per model, as ``fused_layer_apply`` prepares its operands: q/k/v columns
permuted from the torch channel interleave ``c = d*H + h`` into
head-blocked order ``h*Dh + d`` (``_blocked_proj``), the ``1/sqrt(Dh)``
score scale folded into wq / bq, the merge rows permuted the same way
(``_blocked_merge``), and eval BN folded into the first MLP conv.

Activations may be float32 or bfloat16; internals are float32 and the
output has the input dtype (the mixed-precision policy of
``models/mdgat.py:230-239`` in the JAX package). The query axis may have
any length: the GEMM masks its ragged edges.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mdgat_tpu_torch.ops.attention import acc_dtype
from mdgat_tpu_torch.ops.cuda import attention as attn_kernel
from mdgat_tpu_torch.ops.cuda._build import DTYPE_CODES, library


@dataclasses.dataclass(frozen=True)
class LayerWeights:
    """Kernel operands of one layer, ``[K, C]`` row-major matrices."""
    num_heads: int
    wq: torch.Tensor   # [D, D]  head-blocked columns, scale folded
    bq: torch.Tensor   # [D]
    wk: torch.Tensor   # [D, D]  head-blocked columns
    bk: torch.Tensor
    wv: torch.Tensor
    bv: torch.Tensor
    wm: torch.Tensor   # [D, D]  head-blocked rows
    bm: torch.Tensor
    w1: torch.Tensor   # [2D, 2D] BN folded; rows [:D] = w1x, [D:] = w1m
    b1: torch.Tensor   # [2D]
    w2: torch.Tensor   # [2D, D]
    b2: torch.Tensor   # [D]


def _dense(conv, dtype) -> torch.Tensor:
    """Conv1x1 weight [Cout, Cin, 1] -> dense [Cin, Cout]."""
    return conv.weight.detach()[:, :, 0].t().to(dtype)


@torch.no_grad()
def prepare_layer_weights(layer, dtype: torch.dtype = torch.float32
                          ) -> LayerWeights:
    """Kernel operands of an :class:`~mdgat_tpu_torch.models.gnn.
    AttentionalPropagation` (see the module docstring)."""
    h = layer.num_heads
    d = layer.attn.merge.weight.shape[0]
    dh = d // h
    scale = 1.0 / dh ** 0.5

    def blocked_proj(conv, fold=1.0):
        w = _dense(conv, dtype).reshape(d, dh, h).permute(0, 2, 1).reshape(d, d)
        b = conv.bias.detach().to(dtype).reshape(dh, h).t().reshape(d)
        return (w * fold).contiguous(), (b * fold).contiguous()

    wq, bq = blocked_proj(layer.attn.proj[0], scale)
    wk, bk = blocked_proj(layer.attn.proj[1])
    wv, bv = blocked_proj(layer.attn.proj[2])
    wm = _dense(layer.attn.merge, dtype).reshape(dh, h, d).permute(1, 0, 2)
    wm = wm.reshape(d, d).contiguous()
    bm = layer.attn.merge.bias.detach().to(dtype).clone()

    conv1, bn1, _, conv2 = layer.mlp
    f = bn1.fold_scale(dtype)
    w1 = (_dense(conv1, dtype) * f[None, :]).contiguous()
    b1 = ((conv1.bias.to(dtype) - bn1.running_mean.to(dtype)) * f
          + bn1.bias.to(dtype)).contiguous()
    return LayerWeights(h, wq, bq, wk, bk, wv, bv, wm, bm, w1, b1,
                        _dense(conv2, dtype).contiguous(),
                        conv2.bias.detach().to(dtype).clone())


def _split_blocked(t: torch.Tensor, h: int) -> torch.Tensor:
    """[B, N, D] head-blocked columns -> [B, H, N, Dh]."""
    b, n, d = t.shape
    return t.reshape(b, n, h, d // h).permute(0, 2, 1, 3)


def fused_layer_reference(x, src, kv_mask: Optional[torch.Tensor],
                          topk: Optional[int], w: LayerWeights):
    """Plain PyTorch twin of :func:`fused_layer`: the same prepared
    weights and order of operations, with the attention twin."""
    acc = acc_dtype(x.dtype)
    xf, sf = x.to(acc), src.to(acc)
    cast = lambda t: t.to(acc)
    h = w.num_heads
    d = x.shape[-1]
    q = _split_blocked(xf @ cast(w.wq) + cast(w.bq), h)
    k = _split_blocked(sf @ cast(w.wk) + cast(w.bk), h)
    v = _split_blocked(sf @ cast(w.wv) + cast(w.bv), h)
    o, _ = attn_kernel.topk_attention_reference(q, k, v, kv_mask,
                                                int(topk or 0), 1.0)
    merged = o.permute(0, 2, 1, 3).reshape(x.shape) @ cast(w.wm) + cast(w.bm)
    w1 = cast(w.w1)
    u = torch.relu(xf @ w1[:d] + merged @ w1[d:] + cast(w.b1))
    return (xf + (u @ cast(w.w2) + cast(w.b2))).to(x.dtype)


def gemm(a1, w, bias, *, a2=None, relu=False, res=None, out_dtype=None,
         a1_heads=0, out_heads=0, rows_per_batch=0, w_trans=False):
    """``[relu](cat(a1, a2) @ w + bias) [+ res]`` on the kernel of
    ``csrc/gemm.cu`` (CUDA tensors only). ``a1`` is ``[R, K1]`` or, with
    ``a1_heads``, a head-split ``[B, H, rows_per_batch, K1/H]``; the
    output is ``[R, C]`` or, with ``out_heads``, ``[B, H, rows_per_batch,
    C/H]``. With ``w_trans``, ``w`` is ``[C, K]`` and stands for its
    transpose (the backward products ``dq @ wq^T``); that mode takes no
    bias (``bias=None``), the plain mode needs one."""
    if a1.device.type != "cuda":
        raise ValueError("the GEMM kernel takes CUDA tensors")
    k1 = a1.shape[-1] * (a1_heads or 1)
    r = a1.numel() // k1
    k2 = 0 if a2 is None else a2.shape[-1]
    if w_trans:
        w_k, c = w.shape[1], w.shape[0]
    else:
        w_k, c = w.shape
    out_dtype = out_dtype or a1.dtype
    if out_heads:
        out = torch.empty((r // rows_per_batch, out_heads, rows_per_batch,
                           c // out_heads), dtype=out_dtype, device=a1.device)
    else:
        out = torch.empty((r, c), dtype=out_dtype, device=a1.device)
    if (a1.dtype not in DTYPE_CODES or out_dtype not in DTYPE_CODES
            or w.dtype != torch.float32 or w_k != k1 + k2
            or (bias is None) != bool(w_trans)
            or (bias is not None and (bias.dtype != torch.float32
                                      or bias.shape != (c,)))
            or (a2 is not None and (a2.dtype != torch.float32
                                    or a2.numel() != r * k2))
            or (res is not None and (res.dtype != out_dtype
                                     or res.numel() != out.numel()))):
        raise ValueError("GEMM kernel: operand dtypes or shapes")
    for t in (a1, a2, w, bias, res):
        if t is not None and not (t.is_contiguous() and t.device == a1.device):
            raise ValueError("GEMM kernel: operands must be contiguous on "
                             "one device")
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(a1.device):
        stream = torch.cuda.current_stream(a1.device).cuda_stream
        library().call("mdgat_gemm", a1.data_ptr(), DTYPE_CODES[a1.dtype],
                       a1_heads, ptr(a2), k1, k2, w.data_ptr(),
                       ptr(bias), ptr(res), out.data_ptr(),
                       DTYPE_CODES[out_dtype], out_heads, rows_per_batch, r,
                       c, int(relu), int(w_trans), stream)
    gemm.launches += 1
    return out


gemm.launches = 0

TN_ROWS_PER_SPLIT = 512


def gemm_tn(a, b):
    """``(a^T @ b, column sums of b)`` for ``a [R, K1]`` and ``b [R, C]``
    (float32, CUDA): a weight gradient and its bias gradient. The rows are
    split over blocks of ``TN_ROWS_PER_SPLIT``; a second kernel adds the
    blocks' partial results in a fixed order (``csrc/gemm.cu``)."""
    if a.device.type != "cuda":
        raise ValueError("the GEMM kernel takes CUDA tensors")
    r, k1 = a.shape
    c = b.shape[1]
    if (a.dtype != torch.float32 or b.dtype != torch.float32
            or b.shape[0] != r or b.device != a.device
            or not (a.is_contiguous() and b.is_contiguous())):
        raise ValueError("transposed GEMM kernel: operands must be "
                         "contiguous float32 [R, K1] and [R, C] on one device")
    splits = -(-r // TN_ROWS_PER_SPLIT)
    partial = torch.empty((splits, k1 + 1, c), dtype=torch.float32,
                          device=a.device)
    dw = torch.empty((k1, c), dtype=torch.float32, device=a.device)
    db = torch.empty((c,), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        library().call("mdgat_gemm_tn", a.data_ptr(), b.data_ptr(),
                       partial.data_ptr(), dw.data_ptr(), db.data_ptr(), r,
                       k1, c, TN_ROWS_PER_SPLIT, splits, stream)
    gemm_tn.launches += 1
    return dw, db


gemm_tn.launches = 0


def fused_layer(x, src, kv_mask: Optional[torch.Tensor],
                topk: Optional[int], w: LayerWeights):
    """One eval layer ``x [B, N, D]`` attending to ``src [B, M, D]``. A
    CUDA tensor runs the kernels; a CPU tensor the plain twin."""
    if x.device.type == "cpu":
        return fused_layer_reference(x, src, kv_mask, topk, w)
    if x.device.type != "cuda":
        raise ValueError(f"no layer kernel for device {x.device}")
    b, n, d = x.shape
    m = src.shape[1]
    h = w.num_heads
    if src.shape != (b, m, d) or src.dtype != x.dtype:
        raise ValueError("layer kernel: src must be [B, M, D] in x's dtype")
    x = x.contiguous()
    src = src.contiguous()
    f32 = torch.float32
    q = gemm(x, w.wq, w.bq, out_dtype=f32, out_heads=h, rows_per_batch=n)
    k = gemm(src, w.wk, w.bk, out_dtype=f32, out_heads=h, rows_per_batch=m)
    v = gemm(src, w.wv, w.bv, out_dtype=f32, out_heads=h, rows_per_batch=m)
    o, _ = attn_kernel.topk_attention(q, k, v, kv_mask, int(topk or 0), 1.0)
    merged = gemm(o, w.wm, w.bm, a1_heads=h, rows_per_batch=n)
    u = gemm(x, w.w1, w.b1, a2=merged, relu=True, out_dtype=f32)
    y = gemm(u, w.w2, w.b2, res=x, out_dtype=x.dtype)
    fused_layer.launches += 1
    return y.reshape(b, n, d)


fused_layer.launches = 0
