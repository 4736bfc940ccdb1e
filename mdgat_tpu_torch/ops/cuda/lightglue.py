"""LightGlue's kernels (``csrc/lightglue.cu``) and their plain twins.

No TPU kernel is replaced: the JAX package has no LightGlue. The kernels
compute what LightGlue adds to the port (``models/lightglue.py``); its
linear layers run on ``csrc/gemm.cu::gemm_kernel`` through
:func:`linear`. Each wrapper launches its kernels on a CUDA tensor (float32,
TF32 never used) and takes its plain twin, which repeats the kernel's
arithmetic in PyTorch, on a CPU tensor; a CUDA call the kernels cannot take
raises. Each counts its launches (``utils/counting.py``), where its Python
runs: at an eager call and at a capture, never at a replay.

* :func:`self_attention`: dense masked softmax attention at head dim 64
  over q, k, v as the ``Wqkv`` GEMM writes them ([B, 3H, N, 64]: q heads,
  k heads, v heads), the rotary encoding applied to q and k as they are
  loaded (``cos`` / ``sin`` [B, N, 32], upstream's interleaved pairs),
  scale 1/8, padded keys out, an online softmax over key tiles. No score
  slab and no scratch: it captures at any key count.
* :func:`cross_attention`: the two-way cross-attention over [B, 2H, N,
  64] (qk heads, then v heads) of each cloud: ``sim = qk0 qk1^T / 8``
  formed once a tile; ``m0`` (row softmax against v1) completed in the
  block that owns the rows, ``m1`` (column softmax against v0) as a
  partial of each 64-row tile (column max, sum, and the weighted sum of v0
  rows), which a second kernel merges in a fixed order. The partials are a
  scratch of :func:`cross_scratch_floats` floats, sized from the shapes.
* :func:`layer_norm_gelu`: ``GELU(LayerNorm(h))`` (erf form) between an
  FFN's two products, a warp a row.
* :func:`assign`: LightGlue's assignment and decision over the final
  projections ``md`` [B, N, D + 4] (``final_proj`` over ``D^(1/4)`` in
  columns ``:D``, the matchability ``z`` in column ``D``): the row and
  column log-sum-exp of ``sim = md0 md1^T`` over the valid block, the
  inner block ``(sim - lse_row) + (sim - lse_col) + (logsigmoid(z0) +
  logsigmoid(z1))``, its row and column maxima with their first indices,
  the mutual check and ``exp(best) > threshold``, down to ``matches`` and
  ``mscores`` as upstream's ``filter_matches``: four launches (partial
  log-sum-exps, their merge, the recomputed tiles' maxima, the decision),
  and the [B, N, M] matrix is never written.

What bounds them on the H100 and what the designs do about it: the
source note of ``csrc/lightglue.cu``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from mdgat_tpu_torch.ops.cuda._build import library
from mdgat_tpu_torch.ops.cuda.layer import gemm
from mdgat_tpu_torch.ops.matching import filter_matches
from mdgat_tpu_torch.utils.counting import tick

HEAD_DIM = 64          # the kernels' head size (LightGlue's: 256 / 4)
TILE = 64              # rows and columns of a kernel's tile
ASSIGN_PAD = 4         # columns the assignment's operand adds to D
LN_WIDTHS = (128, 256, 512, 1024)   # widths layer_norm_gelu takes


def _check(ok: bool, what: str):
    if not ok:
        raise ValueError(f"LightGlue kernel: {what}")


def _cuda_f32(*ts):
    dev = ts[0].device
    for t in ts:
        _check(t.device == dev and t.is_contiguous()
               and t.dtype in (torch.float32, torch.bool),
               "operands must be contiguous float32 (masks bool) on one "
               "CUDA device")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


# ------------------------------------------------------------------ GEMM
def linear(a1, w, bias, *, a2=None, res=None, a1_heads=0, out_heads=0,
           rows_per_batch=0):
    """``cat(a1, a2) @ w + bias [+ res]`` on ``gemm_kernel`` (layouts as
    ``ops/cuda/layer.py::gemm``: ``a1`` [R, K1] or head-split [B, H, rows,
    K1 / H]; the output [R, C] or head-split [B, out_heads, rows, C /
    out_heads]); on a CPU tensor the same in plain PyTorch."""
    if a1.device.type == "cuda":
        return gemm(a1, w, bias, a2=a2, res=res, a1_heads=a1_heads,
                    out_heads=out_heads, rows_per_batch=rows_per_batch,
                    out_dtype=torch.float32)
    a = a1
    if a1_heads:
        b, h, n, dh = a1.shape
        a = a1.permute(0, 2, 1, 3).reshape(b * n, h * dh)
    if a2 is not None:
        a = torch.cat([a, a2], -1)
    out = a @ w + bias
    if res is not None:
        out = out + res
    if out_heads:
        c = out.shape[-1]
        out = out.reshape(-1, rows_per_batch, out_heads,
                          c // out_heads).permute(0, 2, 1, 3).contiguous()
    return out


# -------------------------------------------------------- self-attention
def _rotate(t, cos, sin):
    """Upstream's ``t cos + rotate_half(t) sin`` on pairs (2i, 2i + 1):
    ``t`` [B, H, N, dh], ``cos`` / ``sin`` [B, N, dh / 2]."""
    x0, x1 = t[..., 0::2], t[..., 1::2]
    c, s = cos[:, None], sin[:, None]
    return torch.stack((x0 * c - x1 * s, x1 * c + x0 * s), -1).flatten(-2)


def _masked_softmax(s, valid, dim):
    s = s.masked_fill(~valid, -math.inf)
    return torch.softmax(s, dim).nan_to_num(0.0)


def self_attention_reference(qkv, cos, sin, mask):
    """Plain twin of :func:`self_attention`."""
    h = qkv.shape[1] // 3
    q, k, v = qkv[:, :h], qkv[:, h:2 * h], qkv[:, 2 * h:]
    q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
    s = (q @ k.transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    return _masked_softmax(s, mask[:, None, None, :].bool(), -1) @ v


def self_attention(qkv, cos, sin, mask):
    """Self-attention of one cloud: ``qkv`` [B, 3H, N, 64], ``cos`` /
    ``sin`` [B, N, 32], ``mask`` [B, N] bool; returns [B, H, N, 64]."""
    if qkv.device.type == "cpu":
        return self_attention_reference(qkv, cos, sin, mask)
    b, h3, n, dh = qkv.shape
    _check(h3 % 3 == 0 and dh == HEAD_DIM, f"qkv {tuple(qkv.shape)}")
    _check(cos.shape == sin.shape == (b, n, dh // 2) and mask.shape == (b, n),
           "cos / sin / mask shapes")
    _cuda_f32(qkv, cos, sin, mask)
    out = torch.empty((b, h3 // 3, n, dh), dtype=torch.float32,
                      device=qkv.device)
    with torch.cuda.device(qkv.device):
        library().call("mdgat_lg_self_attention", qkv.data_ptr(),
                       cos.data_ptr(), sin.data_ptr(), mask.data_ptr(),
                       out.data_ptr(), b, h3 // 3, n, dh, _stream(qkv))
    tick(self_attention)
    return out


self_attention.launches = 0


# ------------------------------------------------------- cross-attention
def cross_scratch_floats(b: int, h: int, n: int, m: int) -> int:
    """Floats of :func:`cross_attention`'s partials: for every (pair, head,
    64-row tile, column) the column's max, its sum and its 64 sums of v0
    rows (``csrc/lightglue.cu::mdgat_lg_cross_attention``)."""
    return b * h * (-(-n // TILE)) * m * (HEAD_DIM + 2)


def cross_attention_reference(qkv0, qkv1, mask0, mask1):
    """Plain twin of :func:`cross_attention`."""
    h = qkv0.shape[1] // 2
    qk0, v0, qk1, v1 = qkv0[:, :h], qkv0[:, h:], qkv1[:, :h], qkv1[:, h:]
    s = (qk0 @ qk1.transpose(-1, -2)) * (qk0.shape[-1] ** -0.5)
    m0 = _masked_softmax(s, mask1[:, None, None, :].bool(), -1) @ v1
    m1 = _masked_softmax(s, mask0[:, None, :, None].bool(), -2).transpose(
        -1, -2) @ v0
    return m0, m1


def cross_attention(qkv0, qkv1, mask0, mask1):
    """Two-way cross-attention: ``qkv0`` [B, 2H, N, 64] and ``qkv1`` [B,
    2H, M, 64] (qk heads, then v heads), masks [B, N] / [B, M] bool;
    returns ``m0`` [B, H, N, 64] and ``m1`` [B, H, M, 64]."""
    if qkv0.device.type == "cpu":
        return cross_attention_reference(qkv0, qkv1, mask0, mask1)
    b, h2, n, dh = qkv0.shape
    m = qkv1.shape[2]
    _check(h2 % 2 == 0 and dh == HEAD_DIM
           and qkv1.shape == (b, h2, m, dh), "qkv shapes")
    _check(mask0.shape == (b, n) and mask1.shape == (b, m), "mask shapes")
    _cuda_f32(qkv0, qkv1, mask0, mask1)
    h = h2 // 2
    m0 = torch.empty((b, h, n, dh), dtype=torch.float32, device=qkv0.device)
    m1 = torch.empty((b, h, m, dh), dtype=torch.float32, device=qkv0.device)
    floats = cross_scratch_floats(b, h, n, m)
    part = torch.empty(floats, dtype=torch.float32, device=qkv0.device)
    with torch.cuda.device(qkv0.device):
        library().call("mdgat_lg_cross_attention", qkv0.data_ptr(),
                       qkv1.data_ptr(), mask0.data_ptr(), mask1.data_ptr(),
                       m0.data_ptr(), m1.data_ptr(), part.data_ptr(), floats,
                       b, h, n, m, dh, _stream(qkv0))
    tick(cross_attention)
    return m0, m1


cross_attention.launches = 0


# ------------------------------------------------------ LayerNorm + GELU
def layer_norm_gelu_reference(x, weight, bias, eps):
    """Plain twin of :func:`layer_norm_gelu`."""
    return F.gelu(F.layer_norm(x, (x.shape[-1],), weight, bias, eps))


def layer_norm_gelu(x, weight, bias, eps: float):
    """``GELU(LayerNorm(x))`` (affine, erf GELU) over the rows of ``x`` [R,
    C], C in :data:`LN_WIDTHS`."""
    if x.device.type == "cpu":
        return layer_norm_gelu_reference(x, weight, bias, eps)
    r, c = x.shape
    _check(c in LN_WIDTHS and weight.shape == bias.shape == (c,),
           f"width {c} not in {LN_WIDTHS}")
    _cuda_f32(x, weight, bias)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        library().call("mdgat_lg_ln_gelu", x.data_ptr(), weight.data_ptr(),
                       bias.data_ptr(), out.data_ptr(), r, c, float(eps),
                       _stream(x))
    tick(layer_norm_gelu)
    return out


layer_norm_gelu.launches = 0


# --------------------------------------------------- assignment, decision
def assign_scratch_floats(b: int, n: int, m: int) -> int:
    """Floats of :func:`assign`'s scratch (``csrc/lightglue.cu::
    AssignScratch``): partial log-sum-exps and maxima a 64-wide tile, the
    merged log-sum-exps and log-sigmoids, the rows' and columns' best."""
    rt, ct = -(-n // TILE), -(-m // TILE)
    return b * (2 * n * ct + 2 * m * rt + 2 * n + 2 * m + 2 * n * ct
                + 2 * m * rt + 2 * n + m)


def _logsigmoid(z):
    return torch.minimum(z, torch.zeros_like(z)) - torch.log1p(
        torch.exp(-z.abs()))


def assign_reference(md0, md1, mask0, mask1, d: int, threshold: float,
                     return_block: bool = False):
    """Plain twin of :func:`assign`; with ``return_block`` also the inner
    block [B, N, M] (-inf outside the valid block)."""
    mask0, mask1 = mask0.bool(), mask1.bool()
    sim = md0[..., :d] @ md1[..., :d].transpose(-1, -2)
    valid = mask0[:, :, None] & mask1[:, None, :]
    s = sim.masked_fill(~valid, -math.inf)
    lr = torch.logsumexp(s, 2, keepdim=True)
    lc = torch.logsumexp(s, 1, keepdim=True)
    lz = _logsigmoid(md0[..., d])[:, :, None] + _logsigmoid(md1[..., d])[
        :, None, :]
    inner = ((s - lr) + (s - lc)) + lz
    inner = inner.masked_fill(~valid, -math.inf)
    out = filter_matches(inner, threshold, mask0, mask1)
    return out + (inner,) if return_block else out


def assign(md0, md1, mask0, mask1, d: int, threshold: float):
    """(matches0 [B, N] int64, matches1 [B, M], mscores0, mscores1) of the
    final projections ``md0`` [B, N, d + 4] / ``md1`` [B, M, d + 4]."""
    if md0.device.type == "cpu":
        return assign_reference(md0, md1, mask0, mask1, d, threshold)
    b, n, ld = md0.shape
    m = md1.shape[1]
    _check(ld == d + ASSIGN_PAD and md1.shape == (b, m, ld) and d % TILE == 0,
           "operand shapes")
    _check(mask0.shape == (b, n) and mask1.shape == (b, m), "mask shapes")
    _cuda_f32(md0, md1, mask0, mask1)
    dev = md0.device
    floats = assign_scratch_floats(b, n, m)
    scratch = torch.empty(floats, dtype=torch.float32, device=dev)
    m0 = torch.empty((b, n), dtype=torch.int64, device=dev)
    m1 = torch.empty((b, m), dtype=torch.int64, device=dev)
    s0 = torch.empty((b, n), dtype=torch.float32, device=dev)
    s1 = torch.empty((b, m), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        library().call("mdgat_lg_assign", md0.data_ptr(), md1.data_ptr(),
                       mask0.data_ptr(), mask1.data_ptr(), scratch.data_ptr(),
                       floats, m0.data_ptr(), m1.data_ptr(), s0.data_ptr(),
                       s1.data_ptr(), b, n, m, d, ld, float(threshold),
                       _stream(md0))
    tick(assign)
    return m0, m1, s0, s1


assign.launches = 0
