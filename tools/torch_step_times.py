#!/usr/bin/env python3
"""Time the port's two main paths on one CUDA card, and nothing else: the
serving forward (flagship model, 64 pairs of 200-256 keypoints, kernel path
and plain path) and the default train step (64 pairs x 512 keypoints), each
by CUDA events and under torch.profiler (device time, busy share); and the
Sinkhorn backward alone (autograd through ``log_optimal_transport_kernel``,
20 iterations, ragged masks) at the train step's 64 x 512 x 512 and at 8 x
1024 x 1024.

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

from chip_smoke import (card_line, cuda_ms, make_pairs, ragged_mask,  # noqa: E402
                        train_batch)


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
    for name, arm in (("kernel", cfg), ("plain", cfg.replace(use_kernels=False))):
        state = create_train_state(arm, device=dev, seed=0)
        step(state, batch)
        out[f"train_step_{name}_ms"] = min(
            cuda_ms(lambda: step(state, batch), reps=3, warmup=1)
            for _ in range(2))
        if name == "kernel":
            dev_ms, win_ms = profiled(lambda: step(state, batch), 1)
            out.update(train_step_device_ms=dev_ms, train_step_window_ms=win_ms)
            # the host alone: enqueue a step without waiting for the card
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, batch)
            out["train_step_enqueue_ms"] = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
        del state
        torch.cuda.empty_cache()

    from mdgat_tpu_torch.ops.cuda.sinkhorn import log_optimal_transport_kernel
    for b, n in ((64, 512), (8, 1024)):
        scores = torch.from_numpy(rng.normal(size=(b, n, n)).astype(np.float32)).to(dev)
        mask = ragged_mask(rng, b, n, int(0.78 * n), dev)
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
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
