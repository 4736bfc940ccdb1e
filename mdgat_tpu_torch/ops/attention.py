"""Full and dynamic top-k attention, plain PyTorch.

Port of ``mdgat_tpu/ops/attention.py``. The reference's dynamic attention
(``models/mdgat.py:196-210``) softmaxes each query row over its top-k
scores only. Here, as in the JAX package, that is a masked softmax whose
mask keeps every entry ``>=`` the row's k-th largest valid score: every tie
at the k-th value is kept. ``torch.topk`` supplies only that threshold,
never the member set (it keeps exactly k under ties).

Semantics shared with the CUDA kernel (``ops/cuda/attention.py``) and with
the JAX package's Pallas kernel (``_stacked_prob``), both arms:

* masked keys carry the ``-1e30`` sentinel, never ``-inf``;
* the k-th value is taken among VALID keys; a row with fewer than k valid
  keys keeps every valid key (its threshold is the smallest valid score);
* the softmax subtracts the row max taken before selection, and the
  denominator is floored at ``1e-30``, so an all-masked row gives zeros
  and no NaN.

Two arms select, as in the JAX package. The exact arm
(:func:`topk_threshold`) keeps the true top-k. The fast arm
(:func:`fast_threshold`, the JAX package's default on its accelerator) is
its value bisection: a few passes of two (or one) midpoint counts bracket
the k-th value from below, and the kept set is every entry at or above the
bracket's low end, which holds the true top-k and possibly a few near-tie
entries more. :func:`fast_iters` gives its resolution from the dtype of the
kernel's input; ``fine_iters`` 0 means the exact arm throughout.

Layout: q ``[B, H, N, Dh]``, k and v ``[B, H, M, Dh]``. Scores, softmax and
the PV product run in float32 for bfloat16 inputs (float64 stays float64);
the output has the input dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

BIG_NEG = -1e30  # -inf stand-in; exp()s to 0, safe in f32 and f64
# the fast arm (``_stacked_prob`` of the JAX package and its defaults):
# ternary passes up to this many keys, binary beyond
KARY_MAX_M = 512
FAST_ITERS_BF16 = 4     # binary-pass resolution a bfloat16 input gets
FAST_ITERS_F32 = 5      # a float32 input
FAST_ITERS_OTHER = 14   # any other dtype (float64)


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


def fast_iters(dtype: torch.dtype) -> int:
    """Resolution of the fast arm for a kernel whose input (q, or the
    layer input x, before any upcast) has ``dtype`` (``_fast_iters`` of the
    JAX package): each dtype the lowest resolution that its measured
    score-noise floor hides."""
    if dtype == torch.bfloat16:
        return FAST_ITERS_BF16
    if dtype == torch.float32:
        return FAST_ITERS_F32
    return FAST_ITERS_OTHER


def fast_plan(m: int, fine_iters: int):
    """``(n_mid, passes)`` of the fast arm over ``m`` keys: two midpoints a
    pass (ternary) up to :data:`KARY_MAX_M` keys, one beyond, and enough
    passes for the binary resolution ``fine_iters``."""
    bits = max(math.ceil(math.log2(m + 1)), 1)
    n_mid = 2 if m <= KARY_MAX_M and 2 * bits <= 24 else 1
    return n_mid, int(math.ceil(fine_iters / math.log2(n_mid + 1)))


def _signed_zero(t: torch.Tensor, pick: torch.Tensor, negative: bool):
    """``t`` with a zero replaced by ``-0.0`` where ``pick`` (else ``+0.0``)
    when ``negative``, the other way round otherwise: the min and max of
    the total order ``-0.0 < +0.0``, which ``amin`` / ``amax`` do not
    keep."""
    zero = torch.zeros((), dtype=t.dtype, device=t.device)
    signed = torch.where(pick, -zero, zero) if negative else \
        torch.where(pick, zero, -zero)
    return torch.where(t == 0, signed, t)


def fast_threshold(s: torch.Tensor, valid: torch.Tensor, topk: int,
                   fine_iters: int) -> torch.Tensor:
    """The fast arm's per-row threshold ``[..., 1]`` of masked scores ``s``
    (invalid entries already ``BIG_NEG``), in ``s``'s dtype, step for step
    as ``_stacked_prob(exact=False)``: ``lo`` the smallest valid score
    (``+1e30`` on an all-masked row), ``hi`` the row max; each pass counts
    ``s >= lo + c_j * (hi - lo)`` for ``c_j = (j + 1) / (n_mid + 1)`` and
    moves ``[lo, hi]`` to the bracket of the largest midpoint whose count
    is at least ``topk``. The threshold is ``lo``; the kept set ``s >= lo``
    holds the true top-k. With fewer than ``topk`` valid scores no count
    reaches ``topk`` and every valid score is kept."""
    n_mid, passes = fast_plan(s.shape[-1], fine_iters)
    negzero = torch.signbit(s) & (s == 0)
    lo = torch.where(valid, s, -BIG_NEG).amin(dim=-1, keepdim=True)
    lo = _signed_zero(lo, (negzero & valid).any(-1, keepdim=True), True)
    hi = s.amax(dim=-1, keepdim=True)
    hi = _signed_zero(hi, ((s == 0) & ~negzero).any(-1, keepdim=True), False)
    cs = [torch.tensor((j + 1) / (n_mid + 1), dtype=s.dtype, device=s.device)
          for j in range(n_mid)]
    for _ in range(passes):
        span = hi - lo
        mids = [lo + c * span for c in cs]
        new_lo, new_hi = lo, mids[0]
        for j, mid in enumerate(mids):
            take = (s >= mid).sum(dim=-1, keepdim=True) >= topk
            new_lo = torch.where(take, mid, new_lo)
            new_hi = torch.where(take, hi if j == n_mid - 1 else mids[j + 1],
                                 new_hi)
        lo, hi = new_lo, new_hi
    return lo


def attention_core(s: torch.Tensor, v: torch.Tensor,
                   kv_mask: Optional[torch.Tensor], topk: Optional[int],
                   return_lse: bool = False, fine_iters: int = 0):
    """Scores ``s`` [B, H, N, M] (accumulation dtype) -> (out [B, H, N,
    Dh] in ``s.dtype``, threshold [B, H, N, 1]). ``topk`` None or 0 is
    dense masked attention (threshold ``BIG_NEG``). With ``return_lse``
    also the per-row logsumexp over the kept entries, ``max + log(denom)``
    (``-1e30`` for an all-masked row).

    Differentiable in ``s`` and ``v``. The selection is a boolean mask
    ``s >= kth`` and the row max only shifts the softmax, so no gradient
    flows through the threshold or the max: the frozen-selection
    semantics of the reference's scatter backward
    (``models/mdgat.py:196-210``). ``fine_iters`` 0 selects with the exact
    arm, a positive value with the fast arm at that resolution."""
    if kv_mask is None:
        valid = torch.ones(s.shape, dtype=torch.bool, device=s.device)
    else:
        valid = kv_mask[:, None, None, :].expand(s.shape)
    s = torch.where(valid, s, BIG_NEG)
    mx = s.detach().amax(dim=-1, keepdim=True)  # pre-selection row max
    if topk:
        thr = (fast_threshold(s.detach(), valid, topk, fine_iters)
               if fine_iters else topk_threshold(s.detach(), valid, topk))
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
                         use_kernels: bool = False, exact: bool = True,
                         kernel_twins: bool = False):
    """MultiHeadedAttention of ``models/mdgat.py:213-237``. ``attn`` holds
    ``proj`` (q, k, v :class:`~mdgat_tpu_torch.ops.mlp.Conv1x1`) and
    ``merge``; topk None selects dense attention. Differentiable. With
    ``use_kernels`` a CUDA tensor (any tensor with ``kernel_twins``) goes
    through the fused-MHA kernel pair (``ops/cuda/mha.py``: projections,
    attention and merge forward and backward on hand-written kernels),
    whose selection is exact or, with ``exact=False``, the fast arm;
    otherwise the plain path below, which is exact."""
    if use_kernels and (x.device.type == "cuda" or kernel_twins):
        from mdgat_tpu_torch.ops.cuda.mha import blocked_weights, fused_mha
        return fused_mha(x, source, kv_mask, topk, num_heads,
                         *blocked_weights(attn, num_heads), exact=exact)
    q = split_heads(attn.proj[0](x), num_heads)
    k = split_heads(attn.proj[1](source), num_heads)
    v = split_heads(attn.proj[2](source), num_heads)
    if topk is None:
        o = full_attention(q, k, v, kv_mask=kv_mask)
    else:
        o = topk_attention(q, k, v, topk, kv_mask=kv_mask)
    return attn.merge(merge_heads(o))
