"""LightGlue (Lindenberger, Sarlin and Pollefeys, ICCV 2023) behind the
contract of ``architectures/__init__.py``: upstream's state dict
(github.com/cvg/LightGlue ``lightglue/lightglue.py``), a plain reference of
its forward written from those equations, the readings of its decision, and
its work counts. It imports nothing of the program.

The reference (:func:`reference_match`), in the precision it is given
(float64 for the reference, float32 with every product's operands rounded
to TF32 for the control, ``harness/reference.py::mm``), with the
configuration's departures from upstream: 3-d keypoints divided by the
fixed ``keypoint_scale``; padded keys left out of every softmax, the
assignment's included; adaptive depth and width off, so every layer runs
and only the last layer's assignment is used; the descriptors L2-normalised
(``reference.inputs``). It returns the inner block of the log assignment
(``log_softmax_rows(sim) + log_softmax_cols(sim) + logsigmoid(z0) +
logsigmoid(z1)^T``) as ``dense``, the dustbins ``logsigmoid(-z1)`` as
``bin_row`` and ``logsigmoid(-z0)`` as ``bin_col``, and upstream's
``filter_matches``: a mutual argmax of the inner block (the dustbins do not
compete), a match where ``exp(score) > filter_threshold``.

Readings (:func:`match_readings`), over valid rows and columns:
``match_gap``, the largest gap in the reference's inner block between an
answered entry and the best of its row and of its column; ``score_err``, an
answered score against ``exp`` of the reference's entry; ``decide_gap``, at
each row or column where the program and the reference disagree on matched
against unmatched, how clear the reference's decision was: the distance of
``exp(best)`` from the threshold and of the best over the runner-up in its
row and in its column where it is mutual, of the column's best over this
row's entry (and of the row's runner-up) where it is not (0 where they
agree).

Work (:func:`work`), over valid keypoints, each byte once, f32 operations
(``harness/work.py``'s peaks): ``flops`` (every product of the forward:
``input_proj``, the positional encoding, every linear layer, the attention
scores and values, the assignment's ``sim``), ``lg_attention_bound_s``
(each self-attention call: scores and values, q, k, v, the encoding and the
mask in, the output out; each cross-attention call: ``sim`` once and both
value products, qk and v of both clouds and the masks in, ``m0`` and ``m1``
out), ``lg_assign_bound_s`` (``sim`` of the final projections, those and
``z`` and the masks in, matches and scores out) and ``gemm_bound_s`` (every
linear layer of ``gemm_kernel``, rows, weights, bias and output once, the
residual read where it is added).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bench_gpu.harness.reference import cast_weights, mm
from bench_gpu.harness.work import F32, bound_s, shape_of

FPFH_DIM = 33
POINT_DIM = 3
POSENC_GAMMA = 1.0     # upstream's: Wr ~ N(0, gamma^-2)


def sizes(config: Dict) -> Dict:
    """The ``model`` block (``descriptor_dim``, ``num_heads``, ``L``,
    ``match_threshold``, ``keypoint_scale``, ...) with the input widths."""
    return {**config["model"], "input_dim": FPFH_DIM, "point_dim": POINT_DIM}


def _linear(name: str, c_in: int, c_out: int):
    return [(f"{name}.weight", (c_out, c_in), "uniform", c_in),
            (f"{name}.bias", (c_out,), "uniform", c_in)]


def _ffn(pre: str, d: int):
    return (_linear(f"{pre}.0", 2 * d, 2 * d)
            + [(f"{pre}.1.weight", (2 * d,), "one", 0),
               (f"{pre}.1.bias", (2 * d,), "zero", 0)]
            + _linear(f"{pre}.3", 2 * d, d))


def param_specs(sizes: Dict) -> List[Tuple[str, tuple, str, float]]:
    """Upstream's state dict in its modules' order: ``uniform`` at each
    ``Linear``'s fan-in (its default), ``posenc.Wr.weight`` from N(0,
    gamma^-2) as upstream draws it, LayerNorm at the identity."""
    d, h, n = sizes["descriptor_dim"], sizes["num_heads"], sizes["L"]
    head = d // h
    out = _linear("input_proj", sizes["input_dim"], d)
    out.append(("posenc.Wr.weight", (head // 2, sizes["point_dim"]), "normal",
                POSENC_GAMMA ** -2))
    for i in range(n):
        pre = f"transformers.{i}"
        out += _linear(f"{pre}.self_attn.Wqkv", d, 3 * d)
        out += _linear(f"{pre}.self_attn.out_proj", d, d)
        out += _ffn(f"{pre}.self_attn.ffn", d)
        for name in ("to_qk", "to_v", "to_out"):
            out += _linear(f"{pre}.cross_attn.{name}", d, d)
        out += _ffn(f"{pre}.cross_attn.ffn", d)
    for i in range(n):
        out += _linear(f"log_assignment.{i}.matchability", d, 1)
        out += _linear(f"log_assignment.{i}.final_proj", d, d)
    for i in range(n - 1):
        out += _linear(f"token_confidence.{i}.token.0", d, 1)
    return out


def gain(name: str, config: Dict) -> float:
    """The configuration's ``weights.final_proj_gain`` on the last layer's
    ``final_proj`` (weight and bias: ``sim`` is sharper by its square) and
    ``weights.matchability_gain`` on its ``matchability`` (weight and bias:
    ``z`` scaled by it), so that the seeded model matches a share of the
    keypoints as a trained one does; 1 elsewhere."""
    last = config["model"]["L"] - 1
    gains = config.get("weights", {})
    if name.startswith(f"log_assignment.{last}.final_proj."):
        return gains.get("final_proj_gain", 1.0)
    if name.startswith(f"log_assignment.{last}.matchability."):
        return gains.get("matchability_gain", 1.0)
    return 1.0


def program_fields(config: Dict) -> Dict:
    return dict(config["model"])


# -------------------------------------------------------------- reference
def _lin(P, name, x, prec):
    return mm(x, P[name + ".weight"].t(), prec) + P[name + ".bias"]


def _softmax(sim, valid, dim):
    return F.softmax(sim.masked_fill(~valid, -math.inf), dim).nan_to_num(0.0)


def _ffn_ref(P, pre, x, msg, prec):
    h = _lin(P, pre + ".0", torch.cat([x, msg], -1), prec)
    h = F.layer_norm(h, (h.shape[-1],), P[pre + ".1.weight"],
                     P[pre + ".1.bias"], 1e-5)
    return x + _lin(P, pre + ".3", F.gelu(h), prec)


def _rotary(t, enc):
    """``t cos + rotate_half(t) sin``, ``enc`` [2, B, 1, N, dh] (the cos
    and sin of ``Wr x``, each repeated twice along the head)."""
    x1, x2 = t.unflatten(-1, (-1, 2)).unbind(dim=-1)
    return t * enc[0] + torch.stack((-x2, x1), -1).flatten(-2) * enc[1]


def _self_block(P, pre, x, enc, mask, heads, prec):
    b, n, d = x.shape
    qkv = _lin(P, pre + ".Wqkv", x, prec)
    qkv = qkv.unflatten(-1, (heads, -1, 3)).transpose(1, 2)
    q, k, v = qkv[..., 0], qkv[..., 1], qkv[..., 2]
    q, k = _rotary(q, enc), _rotary(k, enc)
    sim = mm(q, k.transpose(-1, -2), prec) * q.shape[-1] ** -0.5
    ctx = mm(_softmax(sim, mask[:, None, None, :], -1), v, prec)
    msg = _lin(P, pre + ".out_proj", ctx.transpose(1, 2).reshape(b, n, d),
               prec)
    return _ffn_ref(P, pre + ".ffn", x, msg, prec)


def _cross_block(P, pre, x0, x1, mask0, mask1, heads, prec):
    def split(t):
        return t.unflatten(-1, (heads, -1)).transpose(1, 2)
    qk0, qk1 = split(_lin(P, pre + ".to_qk", x0, prec)), \
        split(_lin(P, pre + ".to_qk", x1, prec))
    v0, v1 = split(_lin(P, pre + ".to_v", x0, prec)), \
        split(_lin(P, pre + ".to_v", x1, prec))
    scale = qk0.shape[-1] ** -0.5
    sim = mm(qk0 * scale ** 0.5, (qk1 * scale ** 0.5).transpose(-1, -2), prec)
    m0 = mm(_softmax(sim, mask1[:, None, None, :], -1), v1, prec)
    m1 = mm(_softmax(sim, mask0[:, None, :, None], -2).transpose(-1, -2), v0,
            prec)
    m0 = _lin(P, pre + ".to_out", m0.transpose(1, 2).flatten(-2), prec)
    m1 = _lin(P, pre + ".to_out", m1.transpose(1, 2).flatten(-2), prec)
    return (_ffn_ref(P, pre + ".ffn", x0, m0, prec),
            _ffn_ref(P, pre + ".ffn", x1, m1, prec))


def _encoding(P, kpts, prec):
    proj = mm(kpts, P["posenc.Wr.weight"].t(), prec)
    enc = torch.stack([torch.cos(proj), torch.sin(proj)], 0).unsqueeze(-3)
    return enc.repeat_interleave(2, dim=-1)


def filter_matches(dense, th, mask0, mask1):
    """Upstream's ``filter_matches`` over the valid inner block (-inf
    elsewhere): matches (-1 unmatched) and mscores."""
    max0, max1 = dense.max(2), dense.max(1)
    m0, m1 = max0.indices, max1.indices
    i0 = torch.arange(m0.shape[1], device=m0.device)[None]
    i1 = torch.arange(m1.shape[1], device=m1.device)[None]
    mutual0 = (i0 == m1.gather(1, m0)) & mask0
    mutual1 = (i1 == m0.gather(1, m1)) & mask1
    zero = dense.new_tensor(0)
    ms0 = torch.where(mutual0, max0.values.exp(), zero)
    ms1 = torch.where(mutual1, ms0.gather(1, m1), zero)
    valid0 = mutual0 & (ms0 > th)
    valid1 = mutual1 & valid0.gather(1, m1)
    return (torch.where(valid0, m0, -1), torch.where(valid1, m1, -1), ms0,
            ms1)


@torch.no_grad()
def reference_match(weights, sizes: Dict, x: Dict, prec):
    P = cast_weights(weights, prec.dtype)
    heads, n_layers = sizes["num_heads"], sizes["L"]
    mask0, mask1 = x["mask0"], x["mask1"]
    scale = sizes["keypoint_scale"]
    enc0 = _encoding(P, x["keypoints0"] / scale, prec)
    enc1 = _encoding(P, x["keypoints1"] / scale, prec)
    d0 = _lin(P, "input_proj", x["descriptors0"], prec)
    d1 = _lin(P, "input_proj", x["descriptors1"], prec)
    for i in range(n_layers):
        pre = f"transformers.{i}"
        d0 = _self_block(P, pre + ".self_attn", d0, enc0, mask0, heads, prec)
        d1 = _self_block(P, pre + ".self_attn", d1, enc1, mask1, heads, prec)
        d0, d1 = _cross_block(P, pre + ".cross_attn", d0, d1, mask0, mask1,
                              heads, prec)
    la = f"log_assignment.{n_layers - 1}"
    dim = d0.shape[-1]
    md0 = _lin(P, la + ".final_proj", d0, prec) / dim ** 0.25
    md1 = _lin(P, la + ".final_proj", d1, prec) / dim ** 0.25
    sim = mm(md0, md1.transpose(-1, -2), prec)
    z0 = _lin(P, la + ".matchability", d0, prec)
    z1 = _lin(P, la + ".matchability", d1, prec)
    valid = mask0[:, :, None] & mask1[:, None, :]
    s = sim.masked_fill(~valid, -math.inf)
    dense = (F.log_softmax(s, 2) + F.log_softmax(s, 1)
             + (F.logsigmoid(z0) + F.logsigmoid(z1).transpose(1, 2)))
    dense = dense.masked_fill(~valid, -math.inf)
    decision = filter_matches(dense, sizes["match_threshold"], mask0, mask1)
    return ((dense, F.logsigmoid(-z1[..., 0]), F.logsigmoid(-z0[..., 0])),
            decision)


def reference_train(weights, sizes, batches, prec, lr, loss_rows=None):
    raise NotImplementedError("no LightGlue loss: no training cell")


def reference_loss(sizes, transport, x):
    raise NotImplementedError("no LightGlue loss: no eval cell")


# --------------------------------------------------------------- readings
def _side(dense, valid_rows, answered, th):
    """For each row of ``dense`` (-inf outside the valid block): whether
    the reference matches it, and how clear that decision is."""
    top = dense.topk(min(2, dense.shape[2]), dim=2)
    best, j = top.values[..., 0], top.indices[..., 0]
    runner = (top.values[..., 1] if top.values.shape[-1] > 1
              else torch.full_like(best, -math.inf))
    ctop = dense.topk(min(2, dense.shape[1]), dim=1)
    cbest, carg = ctop.values[:, 0], ctop.indices[:, 0]
    crunner = (ctop.values[:, 1] if ctop.values.shape[1] > 1
               else torch.full_like(cbest, -math.inf))
    rows = torch.arange(dense.shape[1], device=dense.device)[None]
    mutual = (carg.gather(1, j) == rows) & valid_rows
    matched = mutual & (best.exp() > th)
    row_gap = best - runner
    col_gap = (cbest - crunner).gather(1, j)
    clear = torch.where(
        mutual,
        torch.minimum(torch.minimum((best.exp() - th).abs(), row_gap),
                      col_gap),
        torch.minimum(cbest.gather(1, j) - best, row_gap))
    disagree = valid_rows & (matched != answered)
    return torch.where(disagree, clear, torch.zeros_like(clear))


def match_readings(sizes: Dict, answers, masks, transport) -> Dict[str, float]:
    m0, m1, s0, s1 = answers
    mask0, mask1 = masks
    dense = transport[0]
    th = sizes["match_threshold"]
    dt = dense.dtype
    m0, m1 = m0.long(), m1.long()
    rbest, cbest = dense.amax(2), dense.amax(1)
    a0, a1 = (m0 >= 0) & mask0, (m1 >= 0) & mask1
    at0 = torch.gather(dense, 2, m0.clamp_min(0)[..., None])[..., 0]
    at1 = torch.gather(dense, 1, m1.clamp_min(0)[:, None, :])[:, 0, :]
    gap0 = torch.maximum(rbest, cbest.gather(1, m0.clamp_min(0))) - at0
    gap1 = torch.maximum(cbest, rbest.gather(1, m1.clamp_min(0))) - at1
    gaps = torch.cat([gap0[a0], gap1[a1]])
    errs = torch.cat([(s0.to(dt) - at0.exp()).abs()[a0],
                      (s1.to(dt) - at1.exp()).abs()[a1]])
    decide = torch.cat([
        _side(dense, mask0, m0 >= 0, th)[mask0],
        _side(dense.transpose(1, 2), mask1, m1 >= 0, th)[mask1]])
    return {"match_gap": float(gaps.max()) if gaps.numel() else 0.0,
            "score_err": float(errs.max()) if errs.numel() else 0.0,
            "decide_gap": float(decide.max()) if decide.numel() else 0.0}


# ------------------------------------------------------------------- work
def _gemm(rows: float, k: int, c: int, residual: bool = False):
    """(bytes, operations) of one linear layer over ``rows`` rows."""
    nbytes = F32 * (rows * k + k * c + c + rows * c * (2 if residual else 1))
    return nbytes, 2.0 * rows * k * c


def _linears(sizes: Dict, n0: float, n1: float):
    """(bytes, operations) of every linear layer of a forward over ``n0`` +
    ``n1`` valid rows, one entry a ``gemm_kernel`` call."""
    d = sizes["descriptor_dim"]
    out = [_gemm(n0, sizes["input_dim"], d), _gemm(n1, sizes["input_dim"], d)]
    for _ in range(sizes["L"]):
        for n in (n0, n1):                                   # self blocks
            out += [_gemm(n, d, 3 * d), _gemm(n, d, d), _gemm(n, 2 * d, 2 * d),
                    _gemm(n, 2 * d, d, True)]
        for n in (n0, n1):                                   # cross block
            out += [_gemm(n, d, 2 * d), _gemm(n, d, d), _gemm(n, 2 * d, 2 * d),
                    _gemm(n, 2 * d, d, True)]
    out += [_gemm(n0, d, d + 1), _gemm(n1, d, d + 1)]      # assignment
    return out


def _self_call(n, d, head):
    """(bytes, operations) of a self-attention call over a batch of valid
    counts ``n``: q, k, v, cos, sin and the mask in, the output out."""
    flops = float(np.sum(4.0 * n * n * d))
    nbytes = float(np.sum(F32 * (4 * n * d + n * head) + n))
    return nbytes, flops


def _cross_call(n0, n1, d):
    """(bytes, operations) of a cross-attention call: sim once, both value
    products; qk and v of both clouds and the masks in, m0 and m1 out."""
    flops = float(np.sum(6.0 * n0 * n1 * d))
    nbytes = float(np.sum(F32 * 3 * (n0 + n1) * d + n0 + n1))
    return nbytes, flops


def _assign_call(n0, n1, d):
    """(bytes, operations) of the assignment: sim of the final
    projections; those, z and the masks in, matches (8 bytes) and scores
    (4) out."""
    flops = float(np.sum(2.0 * n0 * n1 * d))
    nbytes = float(np.sum(F32 * (n0 + n1) * (d + 1) + 13 * (n0 + n1)))
    return nbytes, flops


def work(sizes: Dict, host: Dict, train: bool) -> Dict[str, float]:
    if train:
        raise NotImplementedError("no LightGlue training cell")
    shape = shape_of(host)
    n0, n1 = shape["n0"], shape["n1"]
    d, heads = sizes["descriptor_dim"], sizes["num_heads"]
    head = d // heads
    rows0, rows1 = float(np.sum(n0)), float(np.sum(n1))
    linears = _linears(sizes, rows0, rows1)
    attention = [_self_call(n, d, head) for _ in range(sizes["L"])
                 for n in (n0, n1)]
    attention += [_cross_call(n0, n1, d)] * sizes["L"]
    assign = _assign_call(n0, n1, d)
    posenc = 2.0 * (rows0 + rows1) * sizes["point_dim"] * head / 2
    flops = (sum(f for _, f in linears) + sum(f for _, f in attention)
             + assign[1] + posenc)
    return {"pairs": float(len(n0)), "flops": flops,
            "lg_attention_bound_s": sum(bound_s(*a) for a in attention),
            "lg_assign_bound_s": bound_s(*assign),
            "gemm_bound_s": sum(bound_s(*g) for g in linears)}


def eval_readings(model, x: Dict, dtype, device) -> Dict:
    return {}
