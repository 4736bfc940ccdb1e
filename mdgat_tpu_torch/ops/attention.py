"""Full and dynamic top-k attention, plain PyTorch.

Port of ``mdgat_tpu/ops/attention.py``. The reference's dynamic attention
(``models/mdgat.py:196-210``) softmaxes each query row over its top-k
scores only. Here, as in the JAX package, that is a masked softmax whose
mask keeps every entry ``>=`` the row's k-th largest valid score: every tie
at the k-th value is kept. ``torch.topk`` supplies only that threshold,
never the member set (it keeps exactly k under ties).

Semantics shared with the CUDA kernel (``ops/cuda/attention.py``) and with
the JAX package's exact Pallas kernel (``_stacked_prob``, exact arm):

* masked keys carry the ``-1e30`` sentinel, never ``-inf``;
* the k-th value is taken among VALID keys; a row with fewer than k valid
  keys keeps every valid key (its threshold is the smallest valid score);
* the softmax subtracts the row max taken before selection, and the
  denominator is floored at ``1e-30``, so an all-masked row gives zeros
  and no NaN.

Layout: q ``[B, H, N, Dh]``, k and v ``[B, H, M, Dh]``. Scores, softmax and
the PV product run in float32 for bfloat16 inputs (float64 stays float64);
the output has the input dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

BIG_NEG = -1e30  # -inf stand-in; exp()s to 0, safe in f32 and f64


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype: float64 stays, everything else is float32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def topk_threshold(s: torch.Tensor, valid: torch.Tensor,
                   topk: int) -> torch.Tensor:
    """Per-row k-th largest valid score ``[..., 1]`` of masked scores
    ``s`` (invalid entries already ``BIG_NEG``). Rows with fewer than k
    valid entries get their smallest valid score; all-masked rows get
    ``+1e30`` (they keep nothing)."""
    kth = torch.topk(s, min(topk, s.shape[-1]), dim=-1).values[..., -1:]
    min_valid = torch.where(valid, s, -BIG_NEG).amin(dim=-1, keepdim=True)
    return torch.maximum(kth, min_valid)


def attention_core(s: torch.Tensor, v: torch.Tensor,
                   kv_mask: Optional[torch.Tensor], topk: Optional[int],
                   return_lse: bool = False):
    """Scores ``s`` [B, H, N, M] (accumulation dtype) -> (out [B, H, N,
    Dh] in ``s.dtype``, threshold [B, H, N, 1]). ``topk`` None or 0 is
    dense masked attention (threshold ``BIG_NEG``). With ``return_lse``
    also the per-row logsumexp over the kept entries, ``max + log(denom)``
    (``-1e30`` for an all-masked row).

    Differentiable in ``s`` and ``v``. The selection is a boolean mask
    ``s >= kth`` and the row max only shifts the softmax, so no gradient
    flows through the threshold or the max: the frozen-selection
    semantics of the reference's scatter backward
    (``models/mdgat.py:196-210``)."""
    if kv_mask is None:
        valid = torch.ones(s.shape, dtype=torch.bool, device=s.device)
    else:
        valid = kv_mask[:, None, None, :].expand(s.shape)
    s = torch.where(valid, s, BIG_NEG)
    mx = s.detach().amax(dim=-1, keepdim=True)  # pre-selection row max
    if topk:
        thr = topk_threshold(s.detach(), valid, topk)
        keep = valid & (s >= thr)
    else:
        thr = torch.full(s.shape[:-1] + (1,), BIG_NEG, dtype=s.dtype,
                         device=s.device)
        keep = valid
    e = torch.exp(torch.where(keep, s - mx, BIG_NEG))
    denom = e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(e, v.to(s.dtype)) * (1.0 / denom)
    if return_lse:
        return out, thr, mx + torch.log(denom.detach())
    return out, thr


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    acc = acc_dtype(q.dtype)
    return torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale


def full_attention(q, k, v, kv_mask: Optional[torch.Tensor] = None):
    """Dense masked attention (``models/mdgat.py:190-194``)."""
    s = _scores(q, k, q.shape[-1] ** -0.5)
    return attention_core(s, v, kv_mask, None)[0].to(v.dtype)


def topk_attention(q, k, v, topk: int,
                   kv_mask: Optional[torch.Tensor] = None,
                   return_threshold: bool = False):
    """Dynamic top-k attention (``models/mdgat.py:196-210``) with the
    threshold semantics of the module docstring."""
    s = _scores(q, k, q.shape[-1] ** -0.5)
    out, thr = attention_core(s, v, kv_mask, topk)
    out = out.to(v.dtype)
    return (out, thr) if return_threshold else out


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, N, C] -> [B, H, N, Dh] with the reference's channel split
    ``c = d * H + h`` (torch ``view(B, dim, heads, N)``,
    ``models/mdgat.py:227``)."""
    b, n, c = x.shape
    return x.reshape(b, n, c // num_heads, num_heads).permute(0, 3, 1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, N, Dh] -> [B, N, C], inverse of :func:`split_heads`."""
    b, h, n, d = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, n, d * h)


def multi_head_attention(attn, x, source, topk: Optional[int],
                         num_heads: int,
                         kv_mask: Optional[torch.Tensor] = None,
                         use_kernels: bool = False):
    """MultiHeadedAttention of ``models/mdgat.py:213-237``. ``attn`` holds
    ``proj`` (q, k, v :class:`~mdgat_tpu_torch.ops.mlp.Conv1x1`) and
    ``merge``; topk None selects dense attention. Differentiable. With
    ``use_kernels`` a CUDA tensor goes through the fused-MHA kernel pair
    (``ops/cuda/mha.py``: projections, attention and merge forward and
    backward on hand-written kernels); otherwise the plain path below."""
    if use_kernels and x.device.type == "cuda":
        from mdgat_tpu_torch.ops.cuda.mha import blocked_weights, fused_mha
        return fused_mha(x, source, kv_mask, topk, num_heads,
                         *blocked_weights(attn, num_heads))
    q = split_heads(attn.proj[0](x), num_heads)
    k = split_heads(attn.proj[1](source), num_heads)
    v = split_heads(attn.proj[2](source), num_heads)
    if topk is None:
        o = full_attention(q, k, v, kv_mask=kv_mask)
    else:
        o = topk_attention(q, k, v, topk, kv_mask=kv_mask)
    return attn.merge(merge_heads(o))
