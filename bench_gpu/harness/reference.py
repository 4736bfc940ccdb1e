"""The plain reference: MDGAT's forward, loss, gradients and Adam in plain
PyTorch, written from the model's equations (Shi et al., RAL 2021;
nubot-nudt/MDGAT-matcher ``models/mdgat.py``, ``models/pointnet/
pointnet_util.py``, ``load_data.py``). It imports nothing of the program
and takes nothing the program made: it reads the weights the harness made
(upstream state-dict names), and the host batches the harness generated,
and works out again everything the program derives from them (descriptor
normalisation, ground truth, padding, folded weights).

Semantics kept, as the configuration states them:

* masked keys carry ``-1e30``; a top-k layer keeps every valid score at or
  above the row's threshold, found by the value bisection of the top-k
  selection (the configuration's ``exact_topk=False``) at the resolution of
  the configuration's precision (``fine_iters``), or the exact k-th value
  with ``fine_iters=0``; the softmax subtracts the row max taken before
  selection and floors its denominator at ``1e-30``;
* the head split ``c = d * H + h``;
* BatchNorm in training mode over the valid points (the FPFH encoders and
  the GNN) or over every point (the PointNet++ encoder), biased variance,
  eps ``1e-5``; in eval mode the running statistics;
* the dustbin log-Sinkhorn, decomposed, padded rows and columns at the
  sentinel, ``norm = -log(n + m)``;
* the match decision of the gap and triplet losses (the dustbin competes,
  dense wins ties), the gap loss, Adam (b1 0.9, b2 0.999, eps 1e-8).

:class:`Precision` says how it computes: float64 for the reference, and the
control's precision (float32 with every product's operands rounded to TF32,
the nearest precision below the configuration's float32 with TF32 off).
The rounding is done here, so the control reads the same on any device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

BIG_NEG = -1e30
BN_EPS = 1e-5
KARY_MAX_M = 512


@dataclasses.dataclass(frozen=True)
class Precision:
    dtype: torch.dtype = torch.float64
    tf32: bool = False          # round every product's operands to TF32


REFERENCE = Precision(torch.float64, False)
CONTROL = Precision(torch.float32, True)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` as float32 rounded to TF32's 10 mantissa bits (to nearest,
    ties to even), as the tensor cores read their operands."""
    bits = x.float().contiguous().view(torch.int32)
    bits = bits + (0xFFF + ((bits >> 13) & 1))
    return (bits & -8192).view(torch.float32)


class _Tf32MatMul(torch.autograd.Function):
    """A product whose operands are rounded to TF32, forward and backward,
    as TF32 training computes the gradients' products too."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(round_tf32(a), round_tf32(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        ga = torch.matmul(g, round_tf32(b).transpose(-1, -2))
        gb = torch.matmul(round_tf32(a).transpose(-1, -2), g)
        return ga.sum_to_size(a.shape), gb.sum_to_size(b.shape)


def mm(a: torch.Tensor, b: torch.Tensor, prec: Precision) -> torch.Tensor:
    if prec.tf32:
        return _Tf32MatMul.apply(a, b)
    return torch.matmul(a, b)


def model_sizes(config: Dict) -> Dict:
    """A configuration file's ``model`` block, with its ``encoder`` block
    (the PointNet++ encoder's radii, samples and widths) where it has one:
    what the reference, the weights and the work counts read."""
    out = dict(config["model"])
    if "encoder" in config:
        out["encoder"] = config["encoder"]
    return out


# ---------------------------------------------------------------- weights
def _mlp_specs(prefix: str, channels: Sequence[int], conv_dims: int = 1):
    """Upstream names of ``MLP(channels)``: conv at 3i, BN at 3i + 1."""
    out = []
    for i in range(1, len(channels)):
        j = 3 * (i - 1)
        out += _conv_specs(f"{prefix}.{j}", channels[i - 1], channels[i],
                           conv_dims)
        if i < len(channels) - 1:
            out += _bn_specs(f"{prefix}.{j + 1}", channels[i])
    return out


def _conv_specs(name, c_in, c_out, dims=1):
    return [(f"{name}.weight", (c_out, c_in) + (1,) * dims, "uniform", c_in),
            (f"{name}.bias", (c_out,), "uniform", c_in)]


def _bn_specs(name, c):
    return [(f"{name}.weight", (c,), "one", 0), (f"{name}.bias", (c,), "zero", 0),
            (f"{name}.running_mean", (c,), "zero", 0),
            (f"{name}.running_var", (c,), "one", 0),
            (f"{name}.num_batches_tracked", (), "count", 0)]


def param_specs(cfg: Dict) -> List[Tuple[str, tuple, str, int]]:
    """(name, shape, init, fan_in) of every tensor of the state dict, in
    the upstream naming: ``uniform`` is U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    (``Conv1d`` / ``Conv2d``'s default), ``one`` / ``zero`` BatchNorm's."""
    d = cfg["descriptor_dim"]
    kenc = [4] + list(cfg["keypoint_encoder"]) + [d]
    out = []
    if cfg["descriptor"] == "FPFH":
        out += _mlp_specs("kenc.encoder", kenc)
        out += _mlp_specs("denc.encoder",
                          [33] + list(cfg["descriptor_encoder"]) + [d])
    elif cfg["descriptor"] == "pointnetmsg":
        spec = cfg["encoder"]
        for i, widths in enumerate(spec["mlps"]):
            chans = [spec["in_channel"] + 3] + list(widths)
            for j in range(len(widths)):
                out += _conv_specs(f"penc.sa1.conv_blocks.{i}.{j}", chans[j],
                                   chans[j + 1], 2)
                out += _bn_specs(f"penc.sa1.bn_blocks.{i}.{j}", chans[j + 1])
        chans = [sum(w[-1] for w in spec["mlps"]) + 3, 256, 256, d]
        for j in range(3):
            out += _conv_specs(f"penc.sa2.mlp_convs.{j}", chans[j],
                               chans[j + 1], 2)
            out += _bn_specs(f"penc.sa2.mlp_bns.{j}", chans[j + 1])
        out += _mlp_specs("penc.mlp", [2 * d, 2 * d, d])
        out += _mlp_specs("penc.kenc.encoder", kenc)
    else:
        raise ValueError(f"no reference for descriptor {cfg['descriptor']}")
    for i in range(2 * cfg["L"]):
        pre = f"gnn.layers.{i}"
        for j in range(3):
            out += _conv_specs(f"{pre}.attn.proj.{j}", d, d)
        out += _conv_specs(f"{pre}.attn.merge", d, d)
        out += _mlp_specs(f"{pre}.mlp", [2 * d, 2 * d, d])
    out += _conv_specs("final_proj", d, d)
    out.append(("bin_score", (), "bin", 0))
    return out


def trainable(name: str) -> bool:
    return not name.endswith(("running_mean", "running_var",
                              "num_batches_tracked"))


# ------------------------------------------------------------ primitives
def conv(P, name, x, prec):
    w = P[name + ".weight"].flatten(1)
    return mm(x, w.t(), prec) + P[name + ".bias"]


def batchnorm(P, name, x, train, mask=None):
    """Eval: the running statistics. Train: batch statistics over every
    axis but the channel, over the points ``mask`` marks when given."""
    if train:
        axes = tuple(range(x.dim() - 1))
        if mask is None:
            mean = x.mean(dim=axes)
            var = ((x - mean) ** 2).mean(dim=axes)
        else:
            m = mask[..., None].to(x.dtype)
            cnt = m.sum().clamp_min(1.0)
            mean = (x * m).sum(dim=axes) / cnt
            var = ((x - mean) ** 2 * m).sum(dim=axes) / cnt
    else:
        mean, var = P[name + ".running_mean"], P[name + ".running_var"]
    return (x - mean) * torch.rsqrt(var + BN_EPS) * P[name + ".weight"] \
        + P[name + ".bias"]


def mlp(P, prefix, x, n_convs, train, mask, prec):
    """``MLP``: conv, BN, ReLU on every conv but the last."""
    for i in range(n_convs):
        x = conv(P, f"{prefix}.{3 * i}", x, prec)
        if i < n_convs - 1:
            x = torch.relu(batchnorm(P, f"{prefix}.{3 * i + 1}", x, train,
                                     mask))
    return x


# -------------------------------------------------------------- attention
def fast_plan(m: int, fine_iters: int):
    bits = max(math.ceil(math.log2(m + 1)), 1)
    n_mid = 2 if m <= KARY_MAX_M and 2 * bits <= 24 else 1
    return n_mid, int(math.ceil(fine_iters / math.log2(n_mid + 1)))


def _signed_zero(t, pick, negative):
    zero = torch.zeros((), dtype=t.dtype, device=t.device)
    signed = torch.where(pick, -zero, zero) if negative else \
        torch.where(pick, zero, -zero)
    return torch.where(t == 0, signed, t)


def bisect_threshold(s, valid, topk: int, fine_iters: int):
    """Per-row threshold of the value bisection over masked scores ``s``:
    ``lo`` the smallest valid score, ``hi`` the row max; each pass counts
    the scores at or above ``n_mid`` midpoints of ``[lo, hi]`` and moves to
    the bracket of the largest midpoint whose count reaches ``topk``."""
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


def exact_threshold(s, valid, topk: int):
    kth = torch.topk(s, min(topk, s.shape[-1]), dim=-1).values[..., -1:]
    min_valid = torch.where(valid, s, -BIG_NEG).amin(dim=-1, keepdim=True)
    return torch.maximum(kth, min_valid)


def attention(q, k, v, kv_mask, topk, fine_iters, prec):
    """q [B, H, N, Dh], k / v [B, H, M, Dh], kv_mask [B, M]."""
    s = mm(q, k.transpose(-1, -2), prec) * q.shape[-1] ** -0.5
    valid = kv_mask[:, None, None, :].expand(s.shape)
    s = torch.where(valid, s, BIG_NEG)
    mx = s.detach().amax(dim=-1, keepdim=True)
    if topk:
        sd = s.detach()
        thr = (bisect_threshold(sd, valid, topk, fine_iters) if fine_iters
               else exact_threshold(sd, valid, topk))
        keep = valid & (s >= thr)
    else:
        keep = valid
    e = torch.exp(torch.where(keep, s - mx, BIG_NEG))
    denom = e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return mm(e, v, prec) / denom


def split_heads(x, h):
    b, n, c = x.shape
    return x.reshape(b, n, c // h, h).permute(0, 3, 1, 2)


def merge_heads(x):
    b, h, n, d = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, n, d * h)


def gnn_layer(P, i, x, src, kv_mask, row_mask, topk, heads, train,
              fine_iters, prec):
    """The residual update ``MLP(cat(x, MHA(x, src)))`` of layer ``i``."""
    pre = f"gnn.layers.{i}"
    q = split_heads(conv(P, f"{pre}.attn.proj.0", x, prec), heads)
    k = split_heads(conv(P, f"{pre}.attn.proj.1", src, prec), heads)
    v = split_heads(conv(P, f"{pre}.attn.proj.2", src, prec), heads)
    o = attention(q, k, v, kv_mask, topk, fine_iters, prec)
    msg = conv(P, f"{pre}.attn.merge", merge_heads(o), prec)
    return mlp(P, f"{pre}.mlp", torch.cat([x, msg], dim=-1), 2, train,
               row_mask, prec)


def k_schedule(cfg: Dict, n: int) -> List[Optional[int]]:
    """Layer i is top-k iff ``i > 2L - 1 - len(k)``, with
    ``k = k_list[i - 2L + len(k_list)]``; a k of at least the keypoint
    count is dense."""
    n_layers = 2 * cfg["L"]
    klist = list(cfg["k"])
    out = []
    for i in range(n_layers):
        kk = None
        if i > n_layers - 1 - len(klist):
            kk = klist[i - n_layers + len(klist)]
            if kk is not None and kk >= n:
                kk = None
        out.append(kk)
    return out


# --------------------------------------------------------------- PointNet++
def gather_zero(points, idx):
    b, n, c = points.shape
    flat = idx.clamp_max(n - 1).reshape(b, -1, 1).expand(-1, -1, c)
    g = torch.gather(points, 1, flat).reshape(*idx.shape, c)
    return g * (idx < n)[..., None].to(points.dtype)


def ball_groups(xyz, centers, radii, nsamples, prec):
    """Per radius the ``nsample`` lowest-index points within it, ascending,
    a short ball backfilled with its first index, an empty one at the
    sentinel N. ``d2`` by the expansion, in ``prec``."""
    n = xyz.shape[1]
    d2 = ((centers * centers).sum(-1, keepdim=True)
          - 2.0 * mm(centers, xyz.transpose(1, 2), prec)
          + (xyz * xyz).sum(-1)[:, None, :]).clamp_min(0.0)
    ar = torch.arange(n, device=xyz.device)
    out = []
    for r, ns in zip(radii, nsamples):
        key = torch.where(d2 <= r * r, ar, n)
        idx = torch.topk(key, ns, dim=-1, largest=False, sorted=True).values
        out.append(torch.where(idx == n, idx[..., :1], idx))
    return out


def _scale(P, i, n_convs, xyz, feats, kpts, idx, train, prec):
    g = torch.cat([gather_zero(feats, idx),
                   gather_zero(xyz, idx) - kpts[:, :, None, :]], dim=-1)
    for j in range(n_convs):
        g = conv(P, f"penc.sa1.conv_blocks.{i}.{j}", g, prec)
        g = torch.relu(batchnorm(P, f"penc.sa1.bn_blocks.{i}.{j}", g, train))
    return g.amax(dim=2)


def pointnet_msg(P, spec, cloud, kpts, scores, n_kenc, train, prec,
                 blocks: bool):
    """The multi-scale encoder of ``spec`` (a configuration's ``encoder``
    block): ``sa1`` around the keypoints, ``sa2`` over ``cat(kpts,
    pooled)``, then ``MLP(cat(kenc(kpts, scores), sa2))``. ``blocks``
    recomputes each scale in the backward (memory only)."""
    xyz, feats = cloud[..., :3], cloud[..., 3:3 + spec["in_channel"]]
    with torch.no_grad():
        groups = ball_groups(xyz, kpts, spec["radius_list"],
                             spec["nsample_list"], prec)
    pooled = []
    for i, idx in enumerate(groups):
        args = (P, i, len(spec["mlps"][i]), xyz, feats, kpts, idx, train,
                prec)
        pooled.append(checkpoint(_scale, *args, use_reentrant=False)
                      if blocks else _scale(*args))
    h = torch.cat([kpts, torch.cat(pooled, dim=-1)], dim=-1)
    for j in range(3):
        h = conv(P, f"penc.sa2.mlp_convs.{j}", h, prec)
        h = torch.relu(batchnorm(P, f"penc.sa2.mlp_bns.{j}", h, train))
    kenc = mlp(P, "penc.kenc.encoder", torch.cat([kpts, scores[..., None]], -1),
               n_kenc, train, None, prec)
    return mlp(P, "penc.mlp", torch.cat([kenc, h], dim=-1), 2, train, None,
               prec)


# --------------------------------------------------------------- transport
def _lse(x, dim):
    m = x.amax(dim=dim, keepdim=True)
    return torch.log(torch.exp(x - m).sum(dim=dim)) + m.squeeze(dim)


def log_transport(scores, alpha, iters, row_mask, col_mask):
    """(dense [B, N, M], bin_row [B, M], bin_col [B, N]) of the log
    transport with dustbins; the corner is not needed downstream."""
    dt = scores.dtype
    ns = row_mask.sum(dim=1).to(dt)
    ms = col_mask.sum(dim=1).to(dt)
    norm = -torch.log(ns + ms)
    log_mu = torch.where(row_mask, norm[:, None], BIG_NEG)
    log_nu = torch.where(col_mask, norm[:, None], BIG_NEG)
    log_mu_bin, log_nu_bin = torch.log(ms) + norm, torch.log(ns) + norm
    b, n, m = scores.shape
    a = alpha.expand(b)
    dense = torch.where(row_mask[:, :, None] & col_mask[:, None, :], scores,
                        BIG_NEG)
    u = torch.zeros_like(log_mu).masked_fill(~row_mask, BIG_NEG)
    v = torch.zeros_like(log_nu).masked_fill(~col_mask, BIG_NEG)
    u_bin = torch.zeros(b, dtype=dt, device=scores.device)
    v_bin = torch.zeros(b, dtype=dt, device=scores.device)
    for _ in range(iters):
        u = log_mu - torch.logaddexp(_lse(dense + v[:, None, :], 2),
                                     (a + v_bin)[:, None].expand(b, n))
        u_bin = log_mu_bin - torch.logaddexp(_lse(a[:, None] + v, 1),
                                             a + v_bin)
        v = log_nu - torch.logaddexp(_lse(dense + u[:, :, None], 1),
                                     (a + u_bin)[:, None].expand(b, m))
        v_bin = log_nu_bin - torch.logaddexp(_lse(a[:, None] + u, 1),
                                             a + u_bin)
    return (dense + u[:, :, None] + v[:, None, :] - norm[:, None, None],
            a[:, None] + u_bin[:, None] + v - norm[:, None],
            a[:, None] + u + v_bin[:, None] - norm[:, None])


def decide(dense, bin_row, bin_col, row_mask, col_mask):
    """Matches of the gap / triplet decision: the argmax of each row and
    column against its dustbin (-1 = unmatched; dense wins a tie)."""
    dense = torch.where(row_mask[:, :, None] & col_mask[:, None, :], dense,
                        BIG_NEG)
    max0, idx0 = dense.max(dim=2)
    max1, idx1 = dense.max(dim=1)
    m0 = torch.where((max0 >= bin_col) & row_mask, idx0, -1)
    m1 = torch.where((max1 >= bin_row) & col_mask, idx1, -1)
    s0 = torch.where(m0 >= 0, torch.exp(torch.maximum(max0, bin_col)), 0.0)
    s1 = torch.where(m1 >= 0, torch.exp(torch.maximum(max1, bin_row)), 0.0)
    return m0, m1, s0, s1


def gap_loss(dense, bin_row, bin_col, gt0, gt1, gamma, rm, cm):
    b, n, m = dense.shape
    dt, dev = dense.dtype, dense.device

    def mean_over(x, mask):
        mask = mask.to(x.dtype)
        return (x * mask).sum(dim=1) / mask.sum(dim=1).clamp_min(1)

    dense0 = torch.where(cm[:, None, :], dense, BIG_NEG)
    pos_idx0 = torch.where(gt0 < 0, m, gt0)
    is_pos0 = torch.arange(m, device=dev)[None, None, :] == pos_idx0[:, :, None]
    pos0 = torch.where(pos_idx0 == m, bin_col,
                       torch.where(is_pos0, dense0, 0.0).sum(dim=2))[:, :, None]
    c0 = torch.relu(dense0 - pos0 + gamma) * (~is_pos0).to(dt)
    t0 = torch.relu(bin_col - pos0[:, :, 0] + gamma) * (pos_idx0 != m).to(dt)
    loss0 = mean_over(2.0 * torch.log1p(c0.sum(dim=2) + t0), rm)
    dense1 = torch.where(rm[:, :, None], dense, BIG_NEG)
    pos_idx1 = torch.where(gt1 < 0, n, gt1)
    is_pos1 = torch.arange(n, device=dev)[None, :, None] == pos_idx1[:, None, :]
    pos1 = torch.where(pos_idx1 == n, bin_row,
                       torch.where(is_pos1, dense1, 0.0).sum(dim=1))[:, None, :]
    c1 = torch.relu(dense1 - pos1 + gamma) * (~is_pos1).to(dt)
    t1 = torch.relu(bin_row - pos1[:, 0, :] + gamma) * (pos_idx1 != n).to(dt)
    loss1 = mean_over(2.0 * torch.log1p(c1.sum(dim=1) + t1), cm)
    return (loss0 + loss1) / 2.0


# ------------------------------------------------------------ data derived
# the ground truth's distances in the configuration's float32, by the
# expansion |a|^2 - 2ab + |b|^2, are off by a few float32 ulps of |a|^2 +
# |b|^2: where two candidates or a candidate and the threshold lie closer
# than this share of it, float32 may decide either way
GT_ROUNDING = 8 * 2.0 ** -24


def ground_truth(w0, w1, threshold, rm, cm):
    """(matches0, matches1, clear0, clear1): each valid point's nearest
    neighbour in the other cloud (world frame) if closer than
    ``threshold``, else -1, first index on ties; ``clear*`` marks the
    points whose answer no rounding of float32 distances can change (its
    best distance away from the threshold, and from the second best where
    it is under it, by more than :data:`GT_ROUNDING` of the squared
    norms)."""
    d2 = ((w0[:, :, None, :] - w1[:, None, :, :]) ** 2).sum(-1)
    d2 = torch.where(rm[:, :, None] & cm[:, None, :], d2, 1e30)
    t2 = float(threshold) ** 2
    n0 = (w0 * w0).sum(-1)
    n1 = (w1 * w1).sum(-1)
    out = []
    for d, own, other, mask, other_mask in ((d2, n0, n1, rm, cm),
                                            (d2.transpose(1, 2), n1, n0, cm,
                                             rm)):
        two = torch.topk(d, min(2, d.shape[-1]), dim=-1, largest=False)
        best, idx = two.values[..., 0], two.indices[..., 0]
        second = (two.values[..., 1] if d.shape[-1] > 1
                  else torch.full_like(best, 1e30))
        far = torch.where(other_mask, other, 0.0).amax(dim=-1, keepdim=True)
        tol = GT_ROUNDING * (own + far)
        clear = ((best - t2).abs() > tol) & ((best >= t2)
                                             | (second - best > tol))
        match = torch.where((best < t2) & mask, idx, -1)
        out.append((match, clear | ~mask))
    (m0, c0), (m1, c1) = out
    return m0, m1, c0, c1


def inputs(host: Dict, device, dtype, normalize_floor: float = 1e-30):
    """The model's inputs from a stacked host batch (numpy, the
    configuration's float32), in ``dtype`` on ``device``: descriptors
    L2-normalised, masks, and the ground truth from the world keypoints."""
    t = {k: torch.as_tensor(v, device=device) for k, v in host.items()
         if k in ("keypoints0", "keypoints1", "scores0", "scores1",
                  "descriptors0", "descriptors1", "mask0", "mask1",
                  "kpts0_world", "kpts1_world", "cloud0", "cloud1")}
    out = {k: t[k].to(dtype) for k in t if not k.startswith("mask")}
    out["mask0"], out["mask1"] = t["mask0"].bool(), t["mask1"].bool()
    for side in "01":
        de = out["descriptors" + side]
        out["descriptors" + side] = de / torch.linalg.vector_norm(
            de, dim=-1, keepdim=True).clamp_min(normalize_floor)
    return out


# ----------------------------------------------------------------- model
def encode(P, cfg, x, side, train, prec, blocks=False):
    kp, sc, mask = x["keypoints" + side], x["scores" + side], x["mask" + side]
    n_k = len(cfg["keypoint_encoder"]) + 1
    if cfg["descriptor"] == "pointnetmsg":
        return pointnet_msg(P, cfg["encoder"], x["cloud" + side], kp, sc, n_k,
                            train, prec, blocks)
    n_d = len(cfg["descriptor_encoder"]) + 1
    return (mlp(P, "denc.encoder", x["descriptors" + side], n_d, train, mask,
                prec)
            + mlp(P, "kenc.encoder", torch.cat([kp, sc[..., None]], -1), n_k,
                  train, mask, prec))


def transport(P, cfg, x, train, fine_iters, prec, blocks=False):
    """Encoders, the 2L GNN layers, the final projection, the scores and
    the log transport: (dense, bin_row, bin_col)."""
    m0, m1 = x["mask0"], x["mask1"]
    d0, d1 = encode(P, cfg, x, "0", train, prec, blocks), \
        encode(P, cfg, x, "1", train, prec, blocks)
    heads = cfg["num_heads"]
    names = ["self", "cross"] * cfg["L"]
    for i, (name, k) in enumerate(zip(names, k_schedule(cfg, d0.shape[1]))):
        s0, s1, kv0, kv1 = ((d1, d0, m1, m0) if name == "cross"
                            else (d0, d1, m0, m1))
        args0 = (P, i, d0, s0, kv0, m0, k, heads, train, fine_iters, prec)
        args1 = (P, i, d1, s1, kv1, m1, k, heads, train, fine_iters, prec)
        if blocks:
            d0, d1 = (d0 + checkpoint(gnn_layer, *args0, use_reentrant=False),
                      d1 + checkpoint(gnn_layer, *args1, use_reentrant=False))
        else:
            d0, d1 = d0 + gnn_layer(*args0), d1 + gnn_layer(*args1)
    f0, f1 = conv(P, "final_proj", d0, prec), conv(P, "final_proj", d1, prec)
    scores = mm(f0, f1.transpose(1, 2), prec) / math.sqrt(cfg["descriptor_dim"])
    return log_transport(scores, P["bin_score"], cfg["sinkhorn_iterations"],
                         m0, m1)


def cast_weights(weights: Dict[str, torch.Tensor], dtype) -> Dict:
    return {k: (v.to(dtype) if v.is_floating_point() else v)
            for k, v in weights.items()}


@torch.no_grad()
def match(weights, cfg, x, fine_iters, prec):
    """Eval forward: the log transport (dense, bin_row, bin_col) and the
    decision (matches0, matches1, scores0, scores1)."""
    P = cast_weights(weights, prec.dtype)
    dense, bin_row, bin_col = transport(P, cfg, x, False, fine_iters, prec)
    return (dense, bin_row, bin_col), decide(dense, bin_row, bin_col,
                                             x["mask0"], x["mask1"])


def train(weights, cfg, batches: Sequence[Dict], fine_iters, prec,
          lr: float, loss_rows: Optional[int] = None):
    """``len(batches)`` Adam steps from ``weights`` on the batches' inputs
    (:func:`inputs`), each loss the mean of the per-pair gap loss over the
    first ``loss_rows`` pairs (all when None). Returns (losses, the first
    step's gradients, the parameters after the last step), the last two by
    name."""
    P = cast_weights(weights, prec.dtype)
    names = [k for k in P if trainable(k)]
    for k in names:
        P[k] = P[k].detach().clone().requires_grad_(True)
    m = {k: torch.zeros_like(P[k]) for k in names}
    v = {k: torch.zeros_like(P[k]) for k in names}
    losses, first = [], None
    for t, x in enumerate(batches, start=1):
        dense, bin_row, bin_col = transport(P, cfg, x, True, fine_iters, prec,
                                            blocks=True)
        per = gap_loss(dense, bin_row, bin_col, x["gt0"], x["gt1"],
                       cfg["triplet_loss_gamma"], x["mask0"], x["mask1"])
        loss = per[:loss_rows].mean()
        grads = torch.autograd.grad(loss, [P[k] for k in names])
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in zip(names, grads)}
        with torch.no_grad():
            c1, c2 = 1 - 0.9 ** t, 1 - 0.999 ** t
            for k, g in zip(names, grads):
                m[k].mul_(0.9).add_(g, alpha=0.1)
                v[k].mul_(0.999).addcmul_(g, g, value=0.001)
                P[k] -= lr * (m[k] / c1) / ((v[k] / c2).sqrt() + 1e-8)
        del dense, bin_row, bin_col, per, loss, grads
    return losses, first, {k: P[k].detach() for k in names}
