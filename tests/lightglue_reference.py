"""A plain reference of LightGlue for the tests: ``lightglue/lightglue.py``
of github.com/cvg/LightGlue (Lindenberger, Sarlin and Pollefeys, ICCV 2023)
line by line in plain ``torch`` operations, imported by no program code and
importing no kernel of the port and no JAX.

The modules keep upstream's names, so ``state_dict()`` reads as upstream's
and the port's net loads the same tensors. What differs from upstream, as
the port's configuration states it:

* keypoints are 3-d (``M = 3`` inputs of ``posenc.Wr``) and are
  normalised by one fixed ``keypoint_scale`` (upstream's
  ``normalize_keypoints`` carried to 3-d: a box centred on 0 divided by its
  half-width), not by each image's size;
* ``F.scaled_dot_product_attention`` is written out as an explicit masked
  softmax, and every softmax, the assignment's included, leaves padded keys
  out: padded rows and columns take no part (upstream's padded path leaves
  the assignment unmasked). A padded query row still attends to the valid
  keys, so it stays finite; nothing valid reads it;
* adaptive depth and width are off (``depth_confidence`` and
  ``width_confidence`` -1): every layer runs for every keypoint, and
  ``token_confidence`` and the assignments of the layers before the last
  are built and never called;
* ``confidence_thresholds`` is a buffer outside the state dict;
* ``input_proj`` maps the 33-d FPFH descriptors (L2-normalised by the
  caller, as the port's ``Matcher`` does) to ``descriptor_dim``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

FPFH_DIM = 33
POINT_DIM = 3


def masked_softmax(sim, valid, dim):
    """``softmax(sim, dim)`` over the entries ``valid`` marks; 0 elsewhere."""
    sim = sim.masked_fill(~valid, -math.inf)
    return F.softmax(sim, dim).nan_to_num(0.0)


def masked_log_softmax(sim, valid, dim):
    sim = sim.masked_fill(~valid, -math.inf)
    return F.log_softmax(sim, dim)


class LearnableFourierPositionalEncoding(nn.Module):
    def __init__(self, M, dim, F_dim=None, gamma=1.0):
        super().__init__()
        F_dim = F_dim if F_dim is not None else dim
        self.gamma = gamma
        self.Wr = nn.Linear(M, F_dim // 2, bias=False)
        nn.init.normal_(self.Wr.weight.data, mean=0, std=self.gamma ** -2)

    def forward(self, x):
        projected = self.Wr(x)
        cosines, sines = torch.cos(projected), torch.sin(projected)
        emb = torch.stack([cosines, sines], 0).unsqueeze(-3)
        return emb.repeat_interleave(2, dim=-1)


def rotate_half(x):
    x = x.unflatten(-1, (-1, 2))
    x1, x2 = x.unbind(dim=-1)
    return torch.stack((-x2, x1), dim=-1).flatten(start_dim=-2)


def apply_cached_rotary_emb(freqs, t):
    return (t * freqs[0]) + (rotate_half(t) * freqs[1])


def attention(q, k, v, key_mask):
    """Upstream's ``Attention`` with SDPA written out: scale ``d^-0.5``,
    padded keys (``key_mask`` [B, M]) out of the softmax."""
    s = q.shape[-1] ** -0.5
    sim = torch.einsum("...id,...jd->...ij", q, k) * s
    attn = masked_softmax(sim, key_mask[:, None, None, :], -1)
    return torch.einsum("...ij,...jd->...id", attn, v)


def ffn(dim):
    return nn.Sequential(nn.Linear(2 * dim, 2 * dim),
                         nn.LayerNorm(2 * dim, elementwise_affine=True),
                         nn.GELU(), nn.Linear(2 * dim, dim))


class SelfBlock(nn.Module):
    def __init__(self, embed_dim, num_heads):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.Wqkv = nn.Linear(embed_dim, 3 * embed_dim, bias=True)
        self.out_proj = nn.Linear(embed_dim, embed_dim, bias=True)
        self.ffn = ffn(embed_dim)

    def forward(self, x, encoding, mask):
        qkv = self.Wqkv(x)
        qkv = qkv.unflatten(-1, (self.num_heads, -1, 3)).transpose(1, 2)
        q, k, v = qkv[..., 0], qkv[..., 1], qkv[..., 2]
        q = apply_cached_rotary_emb(encoding, q)
        k = apply_cached_rotary_emb(encoding, k)
        context = attention(q, k, v, mask)
        message = self.out_proj(context.transpose(1, 2).flatten(start_dim=-2))
        return x + self.ffn(torch.cat([x, message], -1))


class CrossBlock(nn.Module):
    def __init__(self, embed_dim, num_heads):
        super().__init__()
        self.heads = num_heads
        dim_head = embed_dim // num_heads
        self.scale = dim_head ** -0.5
        inner_dim = dim_head * num_heads
        self.to_qk = nn.Linear(embed_dim, inner_dim, bias=True)
        self.to_v = nn.Linear(embed_dim, inner_dim, bias=True)
        self.to_out = nn.Linear(inner_dim, embed_dim, bias=True)
        self.ffn = ffn(embed_dim)

    def map_(self, func, x0, x1):
        return func(x0), func(x1)

    def forward(self, x0, x1, mask0, mask1):
        qk0, qk1 = self.map_(self.to_qk, x0, x1)
        v0, v1 = self.map_(self.to_v, x0, x1)
        qk0, qk1, v0, v1 = map(
            lambda t: t.unflatten(-1, (self.heads, -1)).transpose(1, 2),
            (qk0, qk1, v0, v1))
        qk0, qk1 = qk0 * self.scale ** 0.5, qk1 * self.scale ** 0.5
        sim = torch.einsum("bhid, bhjd -> bhij", qk0, qk1)
        attn01 = masked_softmax(sim, mask1[:, None, None, :], -1)
        attn10 = masked_softmax(sim.transpose(-2, -1).contiguous(),
                                mask0[:, None, None, :], -1)
        m0 = torch.einsum("bhij, bhjd -> bhid", attn01, v1)
        m1 = torch.einsum("bhji, bhjd -> bhid", attn10.transpose(-2, -1), v0)
        m0, m1 = self.map_(lambda t: t.transpose(1, 2).flatten(start_dim=-2),
                           m0, m1)
        m0, m1 = self.map_(self.to_out, m0, m1)
        x0 = x0 + self.ffn(torch.cat([x0, m0], -1))
        x1 = x1 + self.ffn(torch.cat([x1, m1], -1))
        return x0, x1


class TransformerLayer(nn.Module):
    def __init__(self, embed_dim, num_heads):
        super().__init__()
        self.self_attn = SelfBlock(embed_dim, num_heads)
        self.cross_attn = CrossBlock(embed_dim, num_heads)

    def forward(self, desc0, desc1, encoding0, encoding1, mask0, mask1):
        desc0 = self.self_attn(desc0, encoding0, mask0)
        desc1 = self.self_attn(desc1, encoding1, mask1)
        return self.cross_attn(desc0, desc1, mask0, mask1)


def sigmoid_log_double_softmax(sim, z0, z1, mask0, mask1):
    """The log assignment [B, N+1, M+1] (upstream's), padded rows and
    columns out of both log-softmaxes."""
    b, m, n = sim.shape
    valid = mask0[:, :, None] & mask1[:, None, :]
    certainties = F.logsigmoid(z0) + F.logsigmoid(z1).transpose(1, 2)
    scores0 = masked_log_softmax(sim, valid, 2)
    scores1 = masked_log_softmax(sim.transpose(-1, -2).contiguous(),
                                 valid.transpose(-1, -2), 2).transpose(-1, -2)
    scores = sim.new_full((b, m + 1, n + 1), 0)
    scores[:, :m, :n] = scores0 + scores1 + certainties
    scores[:, :-1, -1] = F.logsigmoid(-z0.squeeze(-1))
    scores[:, -1, :-1] = F.logsigmoid(-z1.squeeze(-1))
    return scores


class MatchAssignment(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.dim = dim
        self.matchability = nn.Linear(dim, 1, bias=True)
        self.final_proj = nn.Linear(dim, dim, bias=True)

    def forward(self, desc0, desc1, mask0, mask1):
        mdesc0, mdesc1 = self.final_proj(desc0), self.final_proj(desc1)
        _, _, d = mdesc0.shape
        mdesc0, mdesc1 = mdesc0 / d ** 0.25, mdesc1 / d ** 0.25
        sim = torch.einsum("bmd,bnd->bmn", mdesc0, mdesc1)
        z0 = self.matchability(desc0)
        z1 = self.matchability(desc1)
        scores = sigmoid_log_double_softmax(sim, z0, z1, mask0, mask1)
        return scores, sim


class TokenConfidence(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.token = nn.Sequential(nn.Linear(dim, 1), nn.Sigmoid())


def filter_matches(scores, th, mask0, mask1):
    """Upstream's ``filter_matches`` over the valid block of ``scores``: a
    mutual argmax of the inner block (the dustbins do not compete; the
    first maximal index wins a tie), a match where ``exp(score) > th``;
    padded rows and columns unmatched with score 0."""
    inner = scores[:, :-1, :-1]
    valid = mask0[:, :, None] & mask1[:, None, :]
    inner = inner.masked_fill(~valid, -math.inf)
    max0, max1 = inner.max(2), inner.max(1)
    m0, m1 = max0.indices, max1.indices
    indices0 = torch.arange(m0.shape[1], device=m0.device)[None]
    indices1 = torch.arange(m1.shape[1], device=m1.device)[None]
    mutual0 = (indices0 == m1.gather(1, m0)) & mask0
    mutual1 = (indices1 == m0.gather(1, m1)) & mask1
    max0_exp = max0.values.exp()
    zero = max0_exp.new_tensor(0)
    mscores0 = torch.where(mutual0, max0_exp, zero)
    mscores1 = torch.where(mutual1, mscores0.gather(1, m1), zero)
    valid0 = mutual0 & (mscores0 > th)
    valid1 = mutual1 & valid0.gather(1, m1)
    m0 = torch.where(valid0, m0, -1)
    m1 = torch.where(valid1, m1, -1)
    return m0, m1, mscores0, mscores1


class LightGlue(nn.Module):
    """``descriptor_dim`` D, ``num_heads``, ``n_layers``,
    ``filter_threshold`` and ``keypoint_scale`` as the port's ``Config``
    names them (``descriptor_dim``, ``num_heads``, ``L``,
    ``match_threshold``, ``keypoint_scale``)."""

    def __init__(self, descriptor_dim=256, num_heads=4, n_layers=9,
                 filter_threshold=0.1, keypoint_scale=30.0, gamma=1.0):
        super().__init__()
        self.filter_threshold = filter_threshold
        self.keypoint_scale = keypoint_scale
        self.n_layers = n_layers
        self.input_proj = nn.Linear(FPFH_DIM, descriptor_dim, bias=True)
        head_dim = descriptor_dim // num_heads
        self.posenc = LearnableFourierPositionalEncoding(
            POINT_DIM, head_dim, head_dim, gamma)
        self.transformers = nn.ModuleList(
            [TransformerLayer(descriptor_dim, num_heads)
             for _ in range(n_layers)])
        self.log_assignment = nn.ModuleList(
            [MatchAssignment(descriptor_dim) for _ in range(n_layers)])
        self.token_confidence = nn.ModuleList(
            [TokenConfidence(descriptor_dim) for _ in range(n_layers - 1)])
        self.register_buffer("confidence_thresholds", torch.tensor(
            [self.confidence_threshold(i) for i in range(n_layers)]),
            persistent=False)

    def confidence_threshold(self, layer_index):
        threshold = 0.8 + 0.1 * math.exp(-4.0 * layer_index / self.n_layers)
        return min(max(threshold, 0), 1)

    def forward(self, kpts0, kpts1, desc0, desc1, mask0, mask1):
        """(log assignment [B, N+1, M+1], matches0, matches1, mscores0,
        mscores1)."""
        kpts0 = kpts0 / self.keypoint_scale
        kpts1 = kpts1 / self.keypoint_scale
        desc0 = self.input_proj(desc0)
        desc1 = self.input_proj(desc1)
        encoding0 = self.posenc(kpts0)
        encoding1 = self.posenc(kpts1)
        for i in range(self.n_layers):
            desc0, desc1 = self.transformers[i](desc0, desc1, encoding0,
                                                encoding1, mask0, mask1)
        scores, _ = self.log_assignment[self.n_layers - 1](desc0, desc1,
                                                           mask0, mask1)
        m0, m1, ms0, ms1 = filter_matches(scores, self.filter_threshold,
                                          mask0, mask1)
        return scores, m0, m1, ms0, ms1
