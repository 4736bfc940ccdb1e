"""The work a batch needs: model operations, attention and GEMM bounds.

Everything is counted from shapes, masks and the k-schedule, never from
what a kernel happens to do: valid rows only (padding is waste), a top-k
row's value products over ``min(k, valid keys)`` entries (the fast
selection may keep a few near-tie keys more; those are not needed), each
input byte read once and each output byte written once. So the counts are
a floor on the work, and a share of the peak built on them cannot pass 100%
unless the time misses part of the work.

Operations are the multiply-adds of the products (2 a multiply-add):
every 1x1 conv, the attention scores and value products, the ball query's
distances, the score product. Elementwise work (BatchNorm, softmax, the
Sinkhorn iterations, the loss) is not counted. A training step counts each
product's forward, its weight gradient, and its input gradient where the
input is not data; attention's backward counts the scores once and four
products over the kept entries (dP, dV, dQ, dK).

Peaks: NVIDIA's data sheet for the H100 SXM, dense, at its 700 W limit:
67 TFLOP/s in float32 outside the tensor cores (the configurations'
precision: TF32 is off), 3.35 TB/s of HBM3.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from bench_gpu.harness.reference import k_schedule

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
F32 = 4


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: bytes at the HBM rate or
    operations at the float32 peak, whichever is longer."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS)


def shape_of(host: Dict) -> Dict:
    """The shape of a stacked host batch: valid keypoints a pair
    (``n0``, ``n1``), padded sizes (``N``, ``M``), raw cloud points."""
    return {"n0": host["mask0"].sum(axis=1).astype(np.float64),
            "n1": host["mask1"].sum(axis=1).astype(np.float64),
            "N": int(host["mask0"].shape[1]), "M": int(host["mask1"].shape[1]),
            "P": int(host["cloud0"].shape[1]) if "cloud0" in host else 0}


def _chain(rows, channels, first_is_data: bool, train: bool) -> float:
    """Operations of a stack of 1x1 convs over ``rows`` rows."""
    fwd = sum(2.0 * rows * a * b for a, b in zip(channels[:-1], channels[1:]))
    if not train:
        return fwd
    first = 2.0 * rows * channels[0] * channels[1]
    return 3.0 * fwd - (first if first_is_data else 0.0)


def layer_calls(cfg: Dict, shape: Dict) -> Iterator[Tuple]:
    """(query rows [B], key rows [B], k) of each GNN layer call: every
    layer once a cloud."""
    ks = k_schedule(cfg, shape["N"])
    names = ["self", "cross"] * cfg["L"]
    for name, k in zip(names, ks):
        for side in "01":
            other = "1" if side == "0" else "0"
            src = other if name == "cross" else side
            yield shape["n" + side], shape["n" + src], k


def _kept(m, k):
    return np.minimum(m, k) if k else m


def attention_fwd(n, m, k, d, heads) -> Tuple[float, float]:
    """(bytes, operations) of one attention call's forward, summed over the
    batch: q, k, v and the mask in, o and a row statistic out."""
    kept = _kept(m, k)
    flops = float(np.sum(2.0 * n * m * d + 2.0 * n * kept * d))
    nbytes = float(np.sum(F32 * (2 * n * d + 2 * m * d + n * heads) + m))
    return nbytes, flops


def attention_bwd(n, m, k, d, heads) -> Tuple[float, float]:
    """(bytes, operations) of one attention call's backward: q, o, dO and
    two row statistics, k, v and the mask in; dq, dk, dv out."""
    kept = _kept(m, k)
    flops = float(np.sum(2.0 * n * m * d + 4 * 2.0 * n * kept * d))
    nbytes = float(np.sum(F32 * (3 * n * d + 2 * n * heads + 2 * m * d
                                 + n * d + 2 * m * d) + m))
    return nbytes, flops


def attention_bound(cfg: Dict, shape: Dict, train: bool) -> float:
    """Seconds the card needs at least for a forward's (with ``train``, a
    step's) attention work."""
    d, h = cfg["descriptor_dim"], cfg["num_heads"]
    total = 0.0
    for n, m, k in layer_calls(cfg, shape):
        total += bound_s(*attention_fwd(n, m, k, d, h))
        if train:
            total += bound_s(*attention_bwd(n, m, k, d, h))
    return total


def layer_gemms(n, m, d) -> List[Tuple[float, float]]:
    """(bytes, operations) of the six products of an eval layer: q, k, v,
    the head merge, the first MLP conv (two operands, no concat) and the
    second (with the residual)."""
    n, m = float(np.sum(n)), float(np.sum(m))

    def g(rows, k_in, c, extra_rows_bytes=0.0):
        nbytes = F32 * (rows * k_in + k_in * c + c + rows * c) + extra_rows_bytes
        return nbytes, 2.0 * rows * k_in * c
    return [g(n, d, d), g(m, d, d), g(m, d, d), g(n, d, d),
            g(n, 2 * d, 2 * d), g(n, 2 * d, d, F32 * n * d)]


def gemm_bound(cfg: Dict, shape: Dict) -> float:
    """Seconds the card needs at least for a forward's layer GEMMs."""
    d = cfg["descriptor_dim"]
    return sum(bound_s(*g) for n, m, _ in layer_calls(cfg, shape)
               for g in layer_gemms(n, m, d))


def _encoder(cfg: Dict, rows: float, cloud_points: int, train: bool) -> float:
    d = cfg["descriptor_dim"]
    kenc = [4] + list(cfg["keypoint_encoder"]) + [d]
    if cfg["descriptor"] == "FPFH":
        denc = [33] + list(cfg["descriptor_encoder"]) + [d]
        return (_chain(rows, kenc, True, train)
                + _chain(rows, denc, True, train))
    spec = cfg["encoder"]
    # one distance product a keypoint and cloud point serves every radius
    total = 2.0 * rows * cloud_points * 3
    for widths, ns in zip(spec["mlps"], spec["nsample_list"]):
        total += _chain(rows * ns, [spec["in_channel"] + 3] + list(widths),
                        True, train)
    pooled = sum(w[-1] for w in spec["mlps"])
    total += _chain(rows, [pooled + 3, 256, 256, d], False, train)
    total += _chain(rows, kenc, True, train)
    total += _chain(rows, [2 * d, 2 * d, d], False, train)
    return total


def model_flops(cfg: Dict, shape: Dict, train: bool) -> float:
    """Operations of one forward (``train``: one training step) over the
    batch."""
    d, h = cfg["descriptor_dim"], cfg["num_heads"]
    rows0, rows1 = float(np.sum(shape["n0"])), float(np.sum(shape["n1"]))
    total = (_encoder(cfg, rows0, shape["P"], train)
             + _encoder(cfg, rows1, shape["P"], train))
    mult = 3.0 if train else 1.0
    for n, m, k in layer_calls(cfg, shape):
        rows_n, rows_m = float(np.sum(n)), float(np.sum(m))
        lin = 2.0 * d * d * (2 * rows_n + 2 * rows_m) \
            + 2.0 * rows_n * (2 * d * 2 * d + 2 * d * d)
        total += mult * lin
        total += attention_fwd(n, m, k, d, h)[1]
        if train:
            total += attention_bwd(n, m, k, d, h)[1]
    total += mult * 2.0 * (rows0 + rows1) * d * d           # final projection
    total += mult * float(np.sum(2.0 * shape["n0"] * shape["n1"] * d))
    return total


def summary(cfg: Dict, host: Dict, train: bool) -> Dict[str, float]:
    """The counts the per-layer readers take, for one batch."""
    shape = shape_of(host)
    return {"pairs": float(len(shape["n0"])),
            "flops": model_flops(cfg, shape, train),
            "attention_bound_s": attention_bound(cfg, shape, train),
            "gemm_bound_s": 0.0 if train else gemm_bound(cfg, shape)}


def per_iteration(summaries: List[Dict], order: List[int]) -> Optional[Dict]:
    """The counts of the batches ``order`` names, summed."""
    if not order:
        return None
    out = {k: 0.0 for k in summaries[0]}
    for i in order:
        for k, v in summaries[i].items():
            out[k] += v
    return out
