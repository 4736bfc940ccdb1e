#!/usr/bin/env python3
"""Time the port's two main paths on one CUDA card, and nothing else: the
serving forward (flagship model, 64 pairs of 200-256 keypoints, kernel path
and plain path) and the default train step (64 pairs x 512 keypoints), each
by CUDA events and under torch.profiler (device time, busy share), with the
step's peak memory; the Sinkhorn forward alone (``log_optimal_transport_
kernel``, 20 iterations, ragged masks) at 64 x 256 x 256, 64 x 512 x 512 and
8 x 1024 x 1024, and its backward (autograd) at the last two; and, at the
train layer's shape (f32, R = 32768, D = 128), device ms a launch from
torch.profiler of ``tl_h1_kernel`` (``h1_stats``), of ``tl_fwd2_kernel``
(``bn_relu_conv2``, also with bfloat16 I/O), of ``tl_dh2_kernel`` in the
BatchNorm backward's two launches (``bn_backward_sums``, ``dh1_kernel``)
and of ``tl_dw2_kernel`` (``dw2_db2``), and the whole-layer training
forward at k = 128 by events; the attention forward (k = 128) at the
serving and train shapes in a CUDA graph and its backward at the train
shape; the gap-loss margin forward and backward in a CUDA graph at 64 x
512 x 512 and 8 x 1024 x 1024; and the train step with
``loss_kernel=True`` (events and device time).

    python3 tools/torch_step_times.py [label]     # from the root of a checkout

It uses only the package's public entry points and ``chip_smoke.py``'s input
makers, so the same file can be copied into a checkout of another commit to
compare two versions on one card in one run (parent, change, change,
parent). Prints one JSON object on its last line.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.getcwd())

from chip_smoke import (card_line, cuda_ms, gap_case, graph_ms,  # noqa: E402
                        make_pairs, ragged_mask, train_batch)


def profiled(fn, reps):
    """(device ms, window ms) per call of ``fn`` under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) * 1e3
    device = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return device / reps, window / reps


def kernel_ms(fn, name, reps):
    """Device ms a launch of the kernels whose name holds ``name``, over
    ``reps`` calls of ``fn`` under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):               # a window may come back without events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and name in e.key]
        count = sum(e.count for e in hits)
        if count:
            return sum(e.self_device_time_total for e in hits) / 1e3 / count
    return float("nan")


def train_layer_kernel_times(rng, dev):
    """ms a launch of tl_h1_kernel, of tl_fwd2_kernel (f32 and bfloat16
    I/O), of tl_dh2_kernel in bn_backward_sums and in dh1_kernel, and of
    tl_dw2_kernel."""
    import torch
    from mdgat_tpu_torch.ops.cuda import train_layer as T
    r, d = 64 * 512, 128

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    x, msg, w1, b1 = t(r, d), t(r, d), t(2 * d, 2 * d) * (2 * d) ** -0.5, t(2 * d)
    g, h1, w2 = t(r, d), t(r, 2 * d), t(2 * d, d) * d ** -0.5
    vec4 = torch.stack([t(2 * d) * 0.3, t(2 * d).abs() + 0.5,
                        t(2 * d).abs() + 0.5, t(2 * d) * 0.2])
    vec6 = torch.cat([vec4, t(2, 2 * d) * 0.1])
    rowmask = ragged_mask(rng, 64, 512, 400, dev).reshape(-1).to(torch.uint8)
    return {"h1_ms": kernel_ms(lambda: T.h1_stats(x, msg, w1, b1, rowmask),
                               "tl_h1_kernel", 10),
            "dh2_sums_ms": kernel_ms(lambda: T.bn_backward_sums(g, h1, w2, vec4),
                                     "tl_dh2_kernel", 10),
            "dh2_dh1_ms": kernel_ms(lambda: T.dh1_kernel(g, h1, w2, vec6, rowmask),
                                    "tl_dh2_kernel", 10),
            "dw2_ms": kernel_ms(lambda: T.dw2_db2(g, h1, vec4), "tl_dw2_kernel", 10),
            **{f"fwd2_{label}_ms": kernel_ms(
                lambda: T.bn_relu_conv2(x.to(dt), h1.to(dt), vec4[2], vec4[3],
                                        w2, b1[:d]), "tl_fwd2_kernel", 10)
               for label, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))}}


def whole_layer_forward_ms(rng, dev):
    """ms of one whole-layer training forward (``fused_train_layer_forward``)
    at 64 x 512 keypoints, D = 128, 4 heads, k = 128, self-attention with a
    ragged key and row mask, by CUDA events."""
    import torch
    from chip_smoke import _random_layer
    from mdgat_tpu_torch.ops.cuda import train_layer as T
    layer = _random_layer(9, dev, 128, 4)
    with torch.no_grad():
        w = [p.clone() for p in T.train_layer_weights(layer)]
    x = torch.from_numpy(rng.normal(size=(64, 512, 128)).astype(np.float32)).to(dev)
    mask = ragged_mask(rng, 64, 512, 400, dev)
    return min(cuda_ms(lambda: T.fused_train_layer_forward(x, x, mask, mask, 128, 4,
                                                           *w), reps=10)
               for _ in range(2))


def attention_times(rng, dev):
    """ms of the attention forward (``topk_attention``, k = 128) in a CUDA
    graph at the serving shape 64 x 4 x 256 x 256 x 32 and the train shape
    64 x 4 x 512 x 512 x 32, and of the attention backward (``mha.
    _attention_backward``: the rows and the keys kernel) at the train
    shape by events, ragged masks."""
    import torch
    from mdgat_tpu_torch.ops.cuda import attention as A
    from mdgat_tpu_torch.ops.cuda import mha as M
    out = {}
    h, dh, kk = 4, 32, 128
    for n in (256, 512):
        q, k, v, do = (torch.from_numpy(rng.normal(size=(64, h, n, dh))
                                        .astype(np.float32)).to(dev)
                       for _ in range(4))
        q = q * dh ** -0.5
        mask = ragged_mask(rng, 64, n, int(0.78 * n), dev)
        with torch.no_grad():
            out[f"attention_fwd_64x{n}_ms"] = min(
                graph_ms(lambda: A.topk_attention(q, k, v, mask, kk, 1.0))
                for _ in range(2))
            if n == 512:
                _, thr, lse = A.topk_attention(q, k, v, mask, kk, 1.0,
                                               return_lse=True)
                out["attention_bwd_64x512_ms"] = min(
                    cuda_ms(lambda: M._attention_backward(q, k, v, do, mask,
                                                          thr, lse), reps=10)
                    for _ in range(2))
    return out


def gap_times(rng, dev):
    """ms of the gap-loss margin forward and backward (``_margins_forward``,
    ``_margins_backward``: every launch of one call) in a CUDA graph at 64 x
    512 x 512 and 8 x 1024 x 1024."""
    import torch
    from mdgat_tpu_torch.ops.cuda import gap_loss as G
    out = {}
    for b, n in ((64, 512), (8, 1024)):
        dense, br, bc, gt0, gt1, rm, cm, ds0, ds1 = gap_case(rng, dev, b, n, n)
        args = (dense, br, bc, gt0, gt1, rm, cm, 0.5)
        with torch.no_grad():
            out[f"gap_fwd_{b}x{n}x{n}_ms"] = min(
                graph_ms(lambda: G._margins_forward(*args)) for _ in range(2))
            cnt = G._margins_forward(*args)[2:]
            out[f"gap_bwd_{b}x{n}x{n}_ms"] = min(
                graph_ms(lambda: G._margins_backward(*args, *cnt, ds0, ds1))
                for _ in range(2))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_step_times: no CUDA device", file=sys.stderr)
        return 2
    from mdgat_tpu_torch import Matcher
    from mdgat_tpu_torch.core.config import train_defaults
    from mdgat_tpu_torch.train import create_train_state, make_train_step

    label = sys.argv[1] if len(sys.argv) > 1 else ""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    out = dict(label=label, card=card_line())
    rng = np.random.default_rng(0)
    pairs = make_pairs(rng, 64)
    for name, flag in (("kernel", True), ("plain", False)):
        matcher = Matcher(seed=0, device=dev, use_kernels=flag)
        batch, _ = matcher.prepare_batch(pairs)
        with torch.inference_mode():
            matcher.model(batch)
            out[f"forward_{name}_ms"] = min(
                cuda_ms(lambda: matcher.model(batch), reps=10, warmup=2)
                for _ in range(3))
            if flag:
                dev_ms, win_ms = profiled(lambda: matcher.model(batch), 3)
                out.update(forward_device_ms=dev_ms, forward_window_ms=win_ms)
        del matcher, batch
    torch.cuda.empty_cache()

    cfg = train_defaults()
    _, batch = train_batch(1, cfg.batch_size, cfg.max_keypoints, dev)
    step = make_train_step()
    for name, arm in (("kernel", cfg), ("plain", cfg.replace(use_kernels=False)),
                      ("loss_kernel", cfg.replace(loss_kernel=True))):
        state = create_train_state(arm, device=dev, seed=0)
        step(state, batch)
        out[f"train_step_{name}_ms"] = min(
            cuda_ms(lambda: step(state, batch), reps=3, warmup=1)
            for _ in range(2))
        if name == "kernel":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            step(state, batch)
            torch.cuda.synchronize()
            out["train_step_peak_bytes"] = torch.cuda.max_memory_allocated()
            dev_ms, win_ms = profiled(lambda: step(state, batch), 1)
            out.update(train_step_device_ms=dev_ms, train_step_window_ms=win_ms)
            # the host alone: enqueue a step without waiting for the card
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, batch)
            out["train_step_enqueue_ms"] = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
        if name == "loss_kernel":
            out["train_step_loss_kernel_device_ms"] = profiled(
                lambda: step(state, batch), 1)[0]
        del state
        torch.cuda.empty_cache()

    from mdgat_tpu_torch.ops.cuda.sinkhorn import log_optimal_transport_kernel
    for b, n in ((64, 256), (64, 512), (8, 1024)):
        scores = torch.from_numpy(rng.normal(size=(b, n, n)).astype(np.float32)).to(dev)
        mask = ragged_mask(rng, b, n, int(0.78 * n), dev)
        with torch.no_grad():
            out[f"sinkhorn_fwd_{b}x{n}x{n}_ms"] = min(
                cuda_ms(lambda: log_optimal_transport_kernel(scores, 1.0, 20,
                                                             mask, mask),
                        reps=10, warmup=2)
                for _ in range(2))
        if n == 256:
            continue
        sc = scores.requires_grad_()
        alpha = torch.tensor(1.0, device=dev, requires_grad=True)
        ot = list(log_optimal_transport_kernel(sc, alpha, 20, mask, mask))
        cot = [torch.ones_like(t) for t in ot]
        out[f"sinkhorn_bwd_{b}x{n}x{n}_ms"] = min(
            cuda_ms(lambda: torch.autograd.grad(ot, [sc, alpha], cot,
                                                retain_graph=True),
                    reps=5, warmup=1)
            for _ in range(2))
        del scores, sc, ot, cot
        torch.cuda.empty_cache()
    out["whole_layer_forward_k128_ms"] = whole_layer_forward_ms(rng, dev)
    out.update(train_layer_kernel_times(rng, dev))
    out.update(attention_times(rng, dev))
    out.update(gap_times(rng, dev))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
