"""LightGlue (Lindenberger, Sarlin and Pollefeys, ICCV 2023) on 3-d keypoint
pairs: the successor of the SuperGlue design that MDGAT extends, served
through ``Matcher(net="lightglue")``.

Port of github.com/cvg/LightGlue ``lightglue/lightglue.py`` at its
published defaults (``descriptor_dim`` 256, ``n_layers`` 9, ``num_heads``
4, ``filter_threshold`` 0.1, ``add_scale_ori`` False), read from this
package's ``Config``: ``descriptor_dim``, ``num_heads``, ``L`` (the
layers), ``match_threshold`` (``filter_threshold``) and
``keypoint_scale``.

* ``input_proj``: ``Linear(33, D)`` from the FPFH descriptors (upstream's
  own layer for inputs narrower than D).
* ``posenc``: ``LearnableFourierPositionalEncoding(3, head_dim)``, ``Wr``
  a ``Linear(3, head_dim / 2)`` drawn from N(0, gamma^-2) (gamma 1,
  upstream's), its cos and sin
  each repeated twice along the head, applied to q and k of every self
  block as ``t cos + rotate_half(t) sin``. Keypoints are divided by
  ``keypoint_scale`` first: upstream's ``normalize_keypoints`` carried to
  3-d, with one fixed scale, so that a pair's answer does not depend on
  its batch.
* Each of the ``L`` layers is a self block on each cloud, then one cross
  block on both. Self: ``Wqkv`` (q, k, v interleaved per head, upstream's
  ``unflatten(-1, (H, dh, 3))``), the rotary encoding, masked softmax at
  ``dh^-0.5``, ``out_proj``, then ``x + ffn(cat(x, msg))`` with ``ffn`` =
  ``Linear(2D, 2D), LayerNorm(2D), GELU (erf), Linear(2D, D)``. Cross:
  ``to_qk`` and ``to_v`` shared by both clouds, ``sim = qk0 qk1^T dh^-0.5``
  once, ``m0 = softmax_rows(sim) v1``, ``m1 = softmax_cols(sim)^T v0``,
  ``to_out`` and the same FFN form.
* The last layer's ``MatchAssignment``: ``final_proj`` on both clouds over
  ``D^(1/4)``, ``sim`` of the two, matchability ``z``; the inner block
  ``log_softmax_rows(sim) + log_softmax_cols(sim) + logsigmoid(z0) +
  logsigmoid(z1)^T``, dustbins ``logsigmoid(-z)``.
* ``filter_matches``: a mutual argmax of the inner block (the dustbins do
  not compete; the first maximal index wins a tie), a match where
  ``exp(score) > filter_threshold``, ``mscores0`` / ``mscores1`` as upstream
  computes them (the exponential of a mutual row's best, also where it is
  under the threshold).

Departures from upstream: keypoints are 3-d (``M = 3``) and normalised by
the fixed scale; adaptive depth and width are not ported (upstream's
``depth_confidence`` / ``width_confidence`` at -1: a captured batch of
ragged pairs runs every layer for every pair, and with seeded weights the
confidence heads would stop at random), so
``token_confidence.*`` and the assignments of the layers before the last
are built, loaded and never called; padded rows and columns are left out of
every softmax, the assignment's included, so a padded pair's answer equals
the pair's alone (a padded query row still attends to the valid keys and
stays finite; nothing valid reads it); ``confidence_thresholds`` is a
buffer outside the state dict. Module names are upstream's, so
``state_dict()`` keys read as upstream's.

Two routes, as MDGAT's. The plain route is the equations above in plain
PyTorch, in ``compute_dtype``. With ``use_kernels`` on a CUDA device (or on
the CPU with ``kernel_twins``) the forward runs the hand-written kernels of
``ops/cuda/lightglue.py`` on weights permuted from the live parameters at
every forward (inside a captured graph too): every linear layer on
``csrc/gemm.cu::gemm_kernel`` (``input_proj``; ``Wqkv`` written
head-split as [B, 3H, N, dh]; ``ffn.0`` over ``cat(x, msg)`` without the
concat; ``ffn.3`` with the residual; ``final_proj`` over ``D^(1/4)`` with
the matchability as one more column), the self-attention kernel (rotary
encoding applied as q and k are loaded), the two-way cross-attention
kernel, ``LayerNorm + GELU`` between each FFN's two products, and the
assignment-and-decision kernels, which never write the [B, N, M] score
matrix. On the CPU the wrappers take their
plain twins. The positional encoding (a [B, N, 3] x [3, dh / 2] product and
its cos and sin) is plain PyTorch on both routes.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from mdgat_tpu_torch.core.config import Config
from mdgat_tpu_torch.models.mdgat import torch_dtype
from mdgat_tpu_torch.ops.cuda import lightglue as lgk
from mdgat_tpu_torch.ops.matching import filter_matches

FPFH_DIM = 33          # the Matcher's descriptors
POINT_DIM = 3          # the keypoints' coordinates
POSENC_GAMMA = 1.0     # upstream's: Wr ~ N(0, gamma^-2)


def _mask(data, side, like):
    m = data.get("mask" + side)
    if m is None:
        return torch.ones(like.shape[:2], dtype=torch.bool, device=like.device)
    return m.bool()


class LearnableFourierPositionalEncoding(nn.Module):
    """Upstream's encoding, ``Wr`` drawn by ``LightGlue.reset_parameters``
    (from N(0, gamma^-2))."""

    def __init__(self, M: int, F_dim: int, **kw):
        super().__init__()
        self.Wr = nn.Linear(M, F_dim // 2, bias=False, **kw)

    def forward(self, x: torch.Tensor):
        """``(cos, sin)`` of ``Wr x``, each [B, N, F_dim / 2]: the
        encoding before upstream's ``repeat_interleave(2)``."""
        projected = self.Wr(x)
        return torch.cos(projected), torch.sin(projected)


def _ffn(dim: int, **kw) -> nn.Sequential:
    return nn.Sequential(nn.Linear(2 * dim, 2 * dim, **kw),
                         nn.LayerNorm(2 * dim, elementwise_affine=True, **kw),
                         nn.GELU(), nn.Linear(2 * dim, dim, **kw))


class SelfBlock(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, **kw):
        super().__init__()
        self.num_heads = num_heads
        self.Wqkv = nn.Linear(embed_dim, 3 * embed_dim, **kw)
        self.out_proj = nn.Linear(embed_dim, embed_dim, **kw)
        self.ffn = _ffn(embed_dim, **kw)


class CrossBlock(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, **kw):
        super().__init__()
        self.heads = num_heads
        self.to_qk = nn.Linear(embed_dim, embed_dim, **kw)
        self.to_v = nn.Linear(embed_dim, embed_dim, **kw)
        self.to_out = nn.Linear(embed_dim, embed_dim, **kw)
        self.ffn = _ffn(embed_dim, **kw)


class TransformerLayer(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, **kw):
        super().__init__()
        self.self_attn = SelfBlock(embed_dim, num_heads, **kw)
        self.cross_attn = CrossBlock(embed_dim, num_heads, **kw)


class MatchAssignment(nn.Module):
    def __init__(self, dim: int, **kw):
        super().__init__()
        self.matchability = nn.Linear(dim, 1, **kw)
        self.final_proj = nn.Linear(dim, dim, **kw)


class TokenConfidence(nn.Module):
    def __init__(self, dim: int, **kw):
        super().__init__()
        self.token = nn.Sequential(nn.Linear(dim, 1, **kw), nn.Sigmoid())


# ------------------------------------------------------------ plain route
def _rotary(t, cos, sin):
    """``t cos + rotate_half(t) sin`` with upstream's interleaved pairs:
    ``t`` [B, H, N, dh], ``cos`` / ``sin`` [B, N, dh / 2]."""
    c = cos.repeat_interleave(2, dim=-1)[:, None]
    s = sin.repeat_interleave(2, dim=-1)[:, None]
    x1, x2 = t.unflatten(-1, (-1, 2)).unbind(dim=-1)
    rot = torch.stack((-x2, x1), dim=-1).flatten(start_dim=-2)
    return t * c + rot * s


def _softmax(sim, valid, dim):
    return F.softmax(sim.masked_fill(~valid, -math.inf), dim).nan_to_num(0.0)


def _self_plain(blk: SelfBlock, x, cos, sin, mask):
    b, n, d = x.shape
    qkv = blk.Wqkv(x).unflatten(-1, (blk.num_heads, -1, 3)).transpose(1, 2)
    q, k, v = qkv[..., 0], qkv[..., 1], qkv[..., 2]
    q, k = _rotary(q, cos, sin), _rotary(k, cos, sin)
    sim = torch.einsum("bhid,bhjd->bhij", q, k) * q.shape[-1] ** -0.5
    ctx = torch.einsum("bhij,bhjd->bhid",
                       _softmax(sim, mask[:, None, None, :], -1), v)
    msg = blk.out_proj(ctx.transpose(1, 2).reshape(b, n, d))
    return x + blk.ffn(torch.cat([x, msg], -1))


def _cross_plain(blk: CrossBlock, x0, x1, mask0, mask1):
    def split(t):
        return t.unflatten(-1, (blk.heads, -1)).transpose(1, 2)
    qk0, qk1 = split(blk.to_qk(x0)), split(blk.to_qk(x1))
    v0, v1 = split(blk.to_v(x0)), split(blk.to_v(x1))
    sim = torch.einsum("bhid,bhjd->bhij", qk0, qk1) * qk0.shape[-1] ** -0.5
    m0 = torch.einsum("bhij,bhjd->bhid",
                      _softmax(sim, mask1[:, None, None, :], -1), v1)
    m1 = torch.einsum("bhij,bhid->bhjd",
                      _softmax(sim, mask0[:, None, :, None], -2), v0)
    m0 = blk.to_out(m0.transpose(1, 2).flatten(start_dim=-2))
    m1 = blk.to_out(m1.transpose(1, 2).flatten(start_dim=-2))
    return (x0 + blk.ffn(torch.cat([x0, m0], -1)),
            x1 + blk.ffn(torch.cat([x1, m1], -1)))


def log_assignment(la: MatchAssignment, desc0, desc1, mask0, mask1):
    """(inner block [B, N, M], dustbins of the columns ``logsigmoid(-z1)``
    [B, M], of the rows ``logsigmoid(-z0)`` [B, N]): upstream's
    ``MatchAssignment`` and ``sigmoid_log_double_softmax``, padded rows
    and columns out of both log-softmaxes."""
    d = desc0.shape[-1]
    md0 = la.final_proj(desc0) / d ** 0.25
    md1 = la.final_proj(desc1) / d ** 0.25
    sim = torch.einsum("bmd,bnd->bmn", md0, md1)
    z0, z1 = la.matchability(desc0), la.matchability(desc1)
    valid = mask0[:, :, None] & mask1[:, None, :]
    s = sim.masked_fill(~valid, -math.inf)
    scores0 = F.log_softmax(s, 2)
    scores1 = F.log_softmax(s, 1)
    inner = scores0 + scores1 + (F.logsigmoid(z0)
                                 + F.logsigmoid(z1).transpose(1, 2))
    return (inner, F.logsigmoid(-z1.squeeze(-1)),
            F.logsigmoid(-z0.squeeze(-1)))


# ----------------------------------------------------------- kernel route
def _qkv_weights(blk: SelfBlock, d: int):
    """``Wqkv`` as a [D, 3D] operand whose output columns are q, k, v, each
    head-blocked (``t * D + h * dh + i``), from upstream's interleave
    ``h * 3 dh + 3 i + t``: the GEMM then writes [B, 3H, N, dh]."""
    h = blk.num_heads
    w = blk.Wqkv.weight.reshape(h, d // h, 3, d).permute(2, 0, 1, 3)
    bias = blk.Wqkv.bias.reshape(h, d // h, 3).permute(2, 0, 1)
    return (w.reshape(3 * d, d).t().contiguous(),
            bias.reshape(3 * d).contiguous())


def _t(lin: nn.Linear):
    return lin.weight.t().contiguous()


def _ffn_kernel(ffn: nn.Sequential, x, msg):
    """``x + ffn(cat(x, msg))`` over rows: the first product without the
    concat, LayerNorm + GELU, the second product with the residual."""
    lin1, ln, _, lin2 = ffn
    h = lgk.linear(x, _t(lin1), lin1.bias, a2=msg)
    u = lgk.layer_norm_gelu(h, ln.weight, ln.bias, ln.eps)
    return lgk.linear(u, _t(lin2), lin2.bias, res=x)


def _self_kernel(blk: SelfBlock, x, cos, sin, mask):
    b, n, d = x.shape
    h = blk.num_heads
    w, bias = _qkv_weights(blk, d)
    rows = x.reshape(b * n, d)
    qkv = lgk.linear(rows, w, bias, out_heads=3 * h, rows_per_batch=n)
    ctx = lgk.self_attention(qkv, cos, sin, mask)
    msg = lgk.linear(ctx, _t(blk.out_proj), blk.out_proj.bias, a1_heads=h,
                     rows_per_batch=n)
    return _ffn_kernel(blk.ffn, rows, msg).reshape(b, n, d)


def _cross_kernel(blk: CrossBlock, x0, x1, mask0, mask1):
    h = blk.heads
    w = torch.cat([_t(blk.to_qk), _t(blk.to_v)], 1)
    bias = torch.cat([blk.to_qk.bias, blk.to_v.bias])
    r0, r1 = (x.reshape(-1, x.shape[-1]) for x in (x0, x1))
    qkv0 = lgk.linear(r0, w, bias, out_heads=2 * h, rows_per_batch=x0.shape[1])
    qkv1 = lgk.linear(r1, w, bias, out_heads=2 * h, rows_per_batch=x1.shape[1])
    m0, m1 = lgk.cross_attention(qkv0, qkv1, mask0, mask1)
    wo = _t(blk.to_out)
    out = []
    for x, r, m in ((x0, r0, m0), (x1, r1, m1)):
        msg = lgk.linear(m, wo, blk.to_out.bias, a1_heads=h,
                         rows_per_batch=x.shape[1])
        out.append(_ffn_kernel(blk.ffn, r, msg).reshape(x.shape))
    return out


def _assignment_weights(la: MatchAssignment, d: int):
    """``final_proj`` over ``D^(1/4)`` beside the matchability: a [D, D +
    4] operand (columns D + 1 to D + 3 zero, so that a row stays 16-byte
    aligned), the one product giving each keypoint's descriptor and its
    ``z``."""
    scale = d ** -0.25
    w = torch.zeros(d, d + lgk.ASSIGN_PAD, dtype=la.final_proj.weight.dtype,
                    device=la.final_proj.weight.device)
    w[:, :d] = _t(la.final_proj) * scale
    w[:, d] = la.matchability.weight[0]
    bias = torch.zeros(d + lgk.ASSIGN_PAD, dtype=w.dtype, device=w.device)
    bias[:d] = la.final_proj.bias * scale
    bias[d] = la.matchability.bias[0]
    return w, bias


class LightGlue(nn.Module):
    # its kernels size their scratch from the shapes alone, never from the
    # card's free memory: captured at any keypoint count
    # (utils/graphs.py::use_graphs)
    captures_any_size = True

    def __init__(self, config: Config, device=None):
        super().__init__()
        if config.descriptor_dim % config.num_heads:
            raise ValueError("LightGlue: num_heads must divide descriptor_dim")
        self.config = config
        kw = dict(dtype=torch_dtype(config.param_dtype), device=device)
        d, h, n = config.descriptor_dim, config.num_heads, config.L
        head_dim = d // h
        self.input_proj = nn.Linear(FPFH_DIM, d, **kw)
        self.posenc = LearnableFourierPositionalEncoding(POINT_DIM, head_dim,
                                                         **kw)
        self.transformers = nn.ModuleList(
            [TransformerLayer(d, h, **kw) for _ in range(n)])
        self.log_assignment = nn.ModuleList(
            [MatchAssignment(d, **kw) for _ in range(n)])
        self.token_confidence = nn.ModuleList(
            [TokenConfidence(d, **kw) for _ in range(n - 1)])
        thresholds = [min(max(0.8 + 0.1 * math.exp(-4.0 * i / n), 0.0), 1.0)
                      for i in range(n)]
        self.register_buffer("confidence_thresholds",
                             torch.tensor(thresholds, device=device),
                             persistent=False)

    @torch.no_grad()
    def reset_parameters(self, seed: int):
        """Seeded init at ``nn.Linear``'s defaults (weights and biases
        U(-1/sqrt(fan_in), 1/sqrt(fan_in))), ``posenc.Wr`` from N(0,
        gamma^-2) as upstream, LayerNorm at the identity."""
        g = torch.Generator(device="cpu").manual_seed(seed)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                bound = 1.0 / math.sqrt(mod.in_features)
                for p in (mod.weight, mod.bias):
                    if p is not None:
                        p.copy_(torch.rand(p.shape, generator=g,
                                           dtype=torch.float64)
                                .mul_(2 * bound).sub_(bound))
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.fill_(0.0)
        wr = self.posenc.Wr.weight
        wr.copy_(torch.randn(wr.shape, generator=g, dtype=torch.float64)
                 * POSENC_GAMMA ** -2)

    def _kernel_route(self, device) -> bool:
        cfg = self.config
        return cfg.use_kernels and (device.type == "cuda" or cfg.kernel_twins)

    def _input_proj(self, desc, kernels: bool):
        if not kernels:
            return self.input_proj(desc)
        b, n, c = desc.shape
        lin = self.input_proj
        return lgk.linear(desc.reshape(b * n, c).contiguous(), _t(lin),
                          lin.bias).reshape(b, n, -1)

    def forward(self, data: Dict[str, torch.Tensor],
                return_full_scores: bool = False) -> Dict[str, torch.Tensor]:
        """``data``: keypoints0/1 [B, N, 3], descriptors0/1 [B, N, 33]
        (L2-normalised, as ``Matcher`` uploads them), optional mask0/1 [B,
        N] bool. Returns matches0/1 (-1 unmatched) and matching_scores0/1;
        with ``return_full_scores`` also ``scores``, the log assignment
        [B, N+1, M+1] of the final descriptors by the plain assignment
        (the kernel route never forms it)."""
        cfg = self.config
        dt = torch_dtype(cfg.compute_dtype)
        kp0, kp1 = data["keypoints0"].to(dt), data["keypoints1"].to(dt)
        mask0, mask1 = _mask(data, "0", kp0), _mask(data, "1", kp1)
        kernels = self._kernel_route(kp0.device)
        desc0, desc1 = (self._input_proj(data["descriptors" + s].to(dt),
                                         kernels) for s in "01")
        cos0, sin0 = self.posenc(kp0 / cfg.keypoint_scale)
        cos1, sin1 = self.posenc(kp1 / cfg.keypoint_scale)
        for layer in self.transformers:
            if kernels:
                desc0 = _self_kernel(layer.self_attn, desc0, cos0, sin0, mask0)
                desc1 = _self_kernel(layer.self_attn, desc1, cos1, sin1, mask1)
                desc0, desc1 = _cross_kernel(layer.cross_attn, desc0, desc1,
                                             mask0, mask1)
            else:
                desc0 = _self_plain(layer.self_attn, desc0, cos0, sin0, mask0)
                desc1 = _self_plain(layer.self_attn, desc1, cos1, sin1, mask1)
                desc0, desc1 = _cross_plain(layer.cross_attn, desc0, desc1,
                                            mask0, mask1)
        la = self.log_assignment[-1]
        if kernels:
            d = cfg.descriptor_dim
            w, bias = _assignment_weights(la, d)
            md0 = lgk.linear(desc0.reshape(-1, d), w, bias).reshape(
                *desc0.shape[:2], -1)
            md1 = lgk.linear(desc1.reshape(-1, d), w, bias).reshape(
                *desc1.shape[:2], -1)
            m0, m1, ms0, ms1 = lgk.assign(md0, md1, mask0, mask1, d,
                                          cfg.match_threshold)
        else:
            inner, _, _ = log_assignment(la, desc0, desc1, mask0, mask1)
            m0, m1, ms0, ms1 = filter_matches(inner, cfg.match_threshold,
                                              mask0, mask1)
        out = {"matches0": m0, "matches1": m1, "matching_scores0": ms0,
               "matching_scores1": ms1}
        if return_full_scores:
            inner, bin_row, bin_col = log_assignment(la, desc0, desc1,
                                                     mask0, mask1)
            b, n, m = inner.shape
            full = inner.new_zeros((b, n + 1, m + 1))
            full[:, :n, :m] = inner
            full[:, :n, m] = bin_col
            full[:, n, :m] = bin_row
            out["scores"] = full
        return out
