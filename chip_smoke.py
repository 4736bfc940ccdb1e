#!/usr/bin/env python3
"""Drive the PyTorch port (``mdgat_tpu_torch``) once on one CUDA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which fails the run (exit code != 0) when it fails:

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. the build: ``nvcc`` compiles ``mdgat_tpu_torch/csrc/*.cu`` for sm_90a;
3. per-kernel parity on the card at the serving shapes, each kernel
   against its plain PyTorch twin on the same inputs: top-k / dense
   attention (B=64, H=4, N=M=256, Dh=32, k=128/64/dense, ragged masks, f32
   and bf16; and B=8, N=M=1024), the GEMM and the whole eval layer at
   D=128, the Sinkhorn (64x256x256 and 8x1024x1024, 20 iterations); and
   shapes off that path (ragged N and M, head sizes 8-64, odd GEMMs);
4. the serving path: the flagship MDGAT (L=9, D=128, default k-schedule,
   20 Sinkhorn iterations) with seeded weights behind
   ``Matcher(device="cuda")``: three ``match_batch`` calls of 64 ragged
   pairs of 200-256 keypoints and one ``register_batch``. The kernel launch
   counters are zeroed just before and read just after: every forward must
   launch the layer kernels 36 times and the Sinkhorn once. The matches
   must agree with the same Matcher run with ``use_kernels=False`` on the
   card on >= 99.9% of valid slots, and with the CPU path on a small batch;
5. times: CUDA-event times of each kernel and of the whole forward, for
   the kernel path and the plain path, beside the card's name and power
   limit; then a torch.profiler window over three kernel-path forwards
   (device time by kernel, the device's busy share).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Full results also go to
``chip_smoke_out/chip_smoke.json``, with ``ptxas.log`` and ``profile.txt``.
Without a CUDA device, or without the package beside this script, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chip_smoke_out")

# Tolerances of kernel vs plain twin on the card, same inputs. f32: both
# sides keep f32 internals; sums run in other orders (sequential FMA in the
# kernels, blocked reductions in torch), which moves results by ~1e-6
# relative. bf16: the output is rounded to bf16 once (about 3 significant
# digits), the internals are f32 on both sides.
TOL = {"attention_f32": 1e-4, "attention_bf16": 2e-2, "layer_f32": 1e-3,
       "layer_bf16": 1e-1, "gemm_f32": 1e-4, "gemm_bf16_rel": 1e-2,
       "sinkhorn_f32": 1e-4}
# Query rows whose k-th and (k+1)-th valid scores lie within this gap are
# near ties: the two sides may keep different sets there, legitimately,
# because the score sums run in other orders. They are counted and left
# out of the attention and layer comparisons.
TIE_GAP = 1e-5
MIN_AGREEMENT = 0.999


def require(ok: bool, what: str):
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def near_tie_rows(s, valid, k: int):
    """[..., N] bool: rows whose k-th and (k+1)-th valid scores are within
    TIE_GAP (s [..., N, M] f32 scores, valid [..., N, M])."""
    import torch
    if not k or k >= s.shape[-1]:
        return torch.zeros(s.shape[:-1], dtype=torch.bool, device=s.device)
    top = torch.where(valid, s, torch.full_like(s, -1e30)).topk(k + 1, dim=-1).values
    return (top[..., k - 1] - top[..., k]) < TIE_GAP


def ragged_mask(rng, b, m, lo, device):
    import torch
    counts = rng.integers(lo, m + 1, size=b)
    counts[0] = m                                   # one full row
    mask = np.arange(m)[None, :] < counts[:, None]
    return torch.from_numpy(mask).to(device)


# ---------------------------------------------------------------------------
# phase 3: per-kernel parity
# ---------------------------------------------------------------------------

def check_attention(rng, dev, report):
    import torch
    from mdgat_tpu_torch.ops.cuda import attention as A
    worst = 0.0
    cases = [(64, 256, k, dt) for k in (128, 64, 0)
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(8, 1024, k, torch.float32) for k in (128, 0)]
    for b, n, k, dt in cases:
        h, dh = 4, 32
        q, kk, v = (torch.from_numpy(rng.normal(size=(b, h, n, dh))
                                     .astype(np.float32)).to(dev, dt)
                    for _ in range(3))
        mask = ragged_mask(rng, b, n, int(0.78 * n), dev)
        o, thr = A.topk_attention(q, kk, v, mask, k, dh ** -0.5)
        o_ref, thr_ref = A.topk_attention_reference(q, kk, v, mask, k,
                                                    dh ** -0.5)
        torch.cuda.synchronize()
        s = torch.matmul(q.float(), kk.float().transpose(-1, -2)) * dh ** -0.5
        valid = mask[:, None, None, :].expand(s.shape)
        tie = near_tie_rows(s, valid, k)
        keep = ~tie
        err = (o.float() - o_ref.float()).abs().amax(-1)[keep].max().item()
        terr = (thr - thr_ref).abs()[..., 0][keep].max().item()
        tol = TOL["attention_f32" if dt == torch.float32 else "attention_bf16"]
        name = f"attention b{b} n{n} k{k} {str(dt)[6:]}"
        print(f"{name}: max|o-o_ref| {err:.3e} max|thr-thr_ref| {terr:.3e} "
              f"tol {tol:g}; near-tie rows left out {int(tie.sum())} of "
              f"{tie.numel()}")
        require(torch.isfinite(o.float()).all().item(), f"{name}: non-finite")
        require(err <= tol and terr <= TOL["attention_f32"], f"{name} disagrees")
        if dt == torch.float32:
            worst = max(worst, err)
    report["topk_attention"]["max_abs_err"] = worst


def _random_layer(seed, dev, d=128, heads=4):
    import torch
    from mdgat_tpu_torch.models.gnn import AttentionalPropagation
    layer = AttentionalPropagation(d, heads, dtype=torch.float32)
    layer.reset_parameters(torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():  # non-trivial BN so the fold is exercised
        bn = layer.mlp[1]
        bn.running_mean.copy_(torch.randn(2 * d, generator=g) * 0.3)
        bn.running_var.copy_(torch.rand(2 * d, generator=g) + 0.5)
        bn.weight.copy_(torch.rand(2 * d, generator=g) + 0.5)
        bn.bias.copy_(torch.randn(2 * d, generator=g) * 0.2)
        layer.mlp[3].bias.copy_(torch.randn(d, generator=g) * 0.1)
    return layer.to(dev).eval()


def check_layer(rng, dev, report):
    import torch
    from mdgat_tpu_torch.ops.cuda import layer as Lk
    layer = _random_layer(5, dev)
    w = layer.kernel_weights()
    worst = 0.0
    for k, dt in ((128, torch.float32), (0, torch.float32),
                  (64, torch.bfloat16)):
        b, n, m, d = 64, 256, 256, 128
        x = torch.from_numpy(rng.normal(size=(b, n, d)).astype(np.float32)).to(dev, dt)
        src = torch.from_numpy(rng.normal(size=(b, m, d)).astype(np.float32)).to(dev, dt)
        mask = ragged_mask(rng, b, m, 200, dev)
        y = Lk.fused_layer(x, src, mask, k, w)
        y_ref = Lk.fused_layer_reference(x, src, mask, k, w)
        torch.cuda.synchronize()
        q = (x.float() @ w.wq + w.bq).reshape(b, n, 4, 32).transpose(1, 2)
        kk = (src.float() @ w.wk + w.bk).reshape(b, m, 4, 32).transpose(1, 2)
        s = q @ kk.transpose(-1, -2)
        tie = near_tie_rows(s, mask[:, None, None, :].expand(s.shape), k).any(1)
        err = (y.float() - y_ref.float()).abs().amax(-1)[~tie].max().item()
        tol = TOL["layer_f32" if dt == torch.float32 else "layer_bf16"]
        name = f"layer d128 b{b} n{n} k{k} {str(dt)[6:]}"
        print(f"{name}: max|y-y_ref| {err:.3e} tol {tol:g}; near-tie rows "
              f"left out {int(tie.sum())} of {tie.numel()}")
        require(y.dtype == dt and y.shape == x.shape, f"{name}: dtype/shape")
        require(torch.isfinite(y.float()).all().item(), f"{name}: non-finite")
        require(err <= tol, f"{name} disagrees")
        if dt == torch.float32:
            worst = max(worst, err)
    report["eval_layer"]["max_abs_err"] = worst

    # the GEMM alone at the layer's largest product, against torch
    x = torch.from_numpy(rng.normal(size=(64 * 256, 256)).astype(np.float32)).to(dev)
    h = Lk.gemm(x, w.w1, w.b1, relu=True)
    h_ref = torch.relu(x @ w.w1 + w.b1)
    err = (h - h_ref).abs().max().item()
    print(f"gemm 16384x256x256 relu: max|h-h_ref| {err:.3e} tol {TOL['gemm_f32']:g}")
    require(err <= TOL["gemm_f32"], "gemm disagrees")
    report["gemm"]["max_abs_err"] = err


def check_ragged(rng, dev):
    """Shapes off the serving path: ragged query and key counts, every head
    size the attention kernel takes, the wider-row kernel variants, odd
    GEMM sizes with both A operands and a bf16 output."""
    import torch
    from mdgat_tpu_torch.ops.cuda import attention as A
    from mdgat_tpu_torch.ops.cuda import layer as Lk
    from mdgat_tpu_torch.ops.cuda import sinkhorn as S

    def t(*shape, dt=torch.float32):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, dt)

    worst = {}
    for b, h, n, m, dh, k in ((3, 4, 37, 45, 8, 8), (3, 4, 37, 45, 16, 0),
                              (3, 2, 37, 45, 32, 8), (3, 2, 37, 45, 64, 8),
                              (2, 2, 300, 300, 32, 128), (2, 4, 70, 700, 32, 64)):
        q, kk, v = t(b, h, n, dh), t(b, h, m, dh), t(b, h, m, dh)
        mask = ragged_mask(rng, b, m, m // 2, dev)
        o, thr = A.topk_attention(q, kk, v, mask, k, dh ** -0.5)
        o_ref, thr_ref = A.topk_attention_reference(q, kk, v, mask, k, dh ** -0.5)
        s = torch.matmul(q, kk.transpose(-1, -2)) * dh ** -0.5
        keep = ~near_tie_rows(s, mask[:, None, None, :].expand(s.shape), k)
        err = max((o - o_ref).abs().amax(-1)[keep].max().item(),
                  (thr - thr_ref).abs()[..., 0][keep].max().item())
        worst[f"attention {b}x{h}x{n}x{m} dh{dh} k{k}"] = (err, TOL["attention_f32"])
    for d, heads, n, m, k, dt in ((32, 4, 37, 45, 8, torch.float32),
                                  (32, 4, 37, 45, None, torch.float32),
                                  (256, 4, 33, 50, 16, torch.bfloat16)):
        w = _random_layer(11, dev, d, heads).kernel_weights()
        x, src = t(3, n, d, dt=dt), t(3, m, d, dt=dt)
        mask = ragged_mask(rng, 3, m, m // 2, dev)
        y = Lk.fused_layer(x, src, mask, k, w)
        y_ref = Lk.fused_layer_reference(x, src, mask, k, w)
        err = (y.float() - y_ref.float()).abs().max().item()
        tol = TOL["layer_f32" if dt == torch.float32 else "layer_bf16"]
        worst[f"layer d{d} {n}x{m} k{k} {str(dt)[6:]}"] = (err, tol)
    a1, a2, w, bias = t(111, 45), t(111, 13), t(58, 70), t(70)
    res = t(111, 70, dt=torch.bfloat16)
    y = Lk.gemm(a1, w, bias, a2=a2, relu=True, res=res, out_dtype=torch.bfloat16)
    y_ref = res.float() + torch.relu(torch.cat([a1, a2], 1) @ w + bias)
    # bf16 output: one rounding, relative 2^-8 at most
    worst["gemm 111x58x70 two A, relu, residual, bf16 out (relative)"] = (
        ((y.float() - y_ref).abs() / y_ref.abs().clamp_min(1.0)).max().item(),
        TOL["gemm_bf16_rel"])
    for b, n, m in ((3, 37, 45), (2, 100, 300), (2, 50, 1000)):
        scores = t(b, n, m)
        rm, cm = ragged_mask(rng, b, n, n // 2, dev), ragged_mask(rng, b, m, m // 2, dev)
        ot = S.log_optimal_transport_kernel(scores, 0.7, 20, rm, cm)
        ref = S.log_optimal_transport_reference(scores, 0.7, 20, rm, cm)
        vb = rm[:, :, None] & cm[:, None, :]
        worst[f"sinkhorn {b}x{n}x{m}"] = (max(
            (ot.dense - ref.dense).abs()[vb].max().item(),
            (ot.bin_row - ref.bin_row).abs()[cm].max().item(),
            (ot.bin_col - ref.bin_col).abs()[rm].max().item(),
            (ot.corner - ref.corner).abs().max().item()), TOL["sinkhorn_f32"])
    torch.cuda.synchronize()
    for name, (err, tol) in worst.items():
        print(f"ragged {name}: max err {err:.3e} tol {tol:g}")
        require(err <= tol, f"ragged {name} disagrees")


def check_sinkhorn(rng, dev, report):
    import torch
    from mdgat_tpu_torch.ops.cuda import sinkhorn as S
    worst = 0.0
    for b, n in ((64, 256), (8, 1024)):
        scores = torch.from_numpy(rng.normal(size=(b, n, n)).astype(np.float32)).to(dev)
        rm = ragged_mask(rng, b, n, int(0.78 * n), dev)
        cm = ragged_mask(rng, b, n, int(0.78 * n), dev)
        ot = S.log_optimal_transport_kernel(scores, 1.0, 20, rm, cm)
        ref = S.log_optimal_transport_reference(scores, 1.0, 20, rm, cm)
        torch.cuda.synchronize()
        vb = rm[:, :, None] & cm[:, None, :]
        errs = [(ot.dense - ref.dense).abs()[vb].max().item(),
                (ot.bin_row - ref.bin_row).abs()[cm].max().item(),
                (ot.bin_col - ref.bin_col).abs()[rm].max().item(),
                (ot.corner - ref.corner).abs().max().item()]
        err = max(errs)
        name = f"sinkhorn {b}x{n}x{n} 20 it"
        print(f"{name}: max err dense/bin_row/bin_col/corner "
              f"{' '.join(f'{e:.3e}' for e in errs)} tol {TOL['sinkhorn_f32']:g}")
        require(bool((ot.dense[~vb] < -1e29).all()), f"{name}: padding leaked")
        require(err <= TOL["sinkhorn_f32"], f"{name} disagrees")
        worst = max(worst, err)
    report["sinkhorn"]["max_abs_err"] = worst


# ---------------------------------------------------------------------------
# phase 4: the serving path
# ---------------------------------------------------------------------------

def make_pairs(rng, count, lo=200, hi=256):
    """Ragged pairs: cloud 1 is a rigidly moved, noisy subset of cloud 0
    plus fresh points; FPFH-like non-negative 33-d descriptors."""
    pairs = []
    for _ in range(count):
        n0, n1 = rng.integers(lo, hi + 1, size=2)
        kp0 = rng.uniform(-30, 30, size=(n0, 3))
        desc0 = np.abs(rng.normal(size=(n0, 33)))
        shared = int(0.7 * min(n0, n1))
        th = rng.uniform(-0.3, 0.3)
        R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                      [0, 0, 1]])
        kp1 = np.concatenate([kp0[:shared] @ R.T + rng.normal(size=3),
                              rng.uniform(-30, 30, size=(n1 - shared, 3))])
        kp1[:shared] += rng.normal(scale=0.05, size=(shared, 3))
        desc1 = np.concatenate([desc0[:shared] + 0.05 * rng.normal(size=(shared, 33)),
                                np.abs(rng.normal(size=(n1 - shared, 33)))])
        pairs.append(dict(kp0=kp0, desc0=desc0, score0=rng.uniform(10, 30, n0),
                          kp1=kp1, desc1=np.abs(desc1),
                          score1=rng.uniform(10, 30, n1)))
    return pairs


def agreement(outs_a, outs_b):
    same = total = 0
    for a, b in zip(outs_a, outs_b):
        for key in ("matches0", "matches1"):
            same += int((a[key] == b[key]).sum())
            total += a[key].size
    return same / total


def check_outputs(outs, pairs):
    for o, p in zip(outs, pairs):
        n0, n1 = len(p["kp0"]), len(p["kp1"])
        require(o["matches0"].shape == (n0,) and o["matches1"].shape == (n1,),
                "match shapes")
        require(o["matches0"].min() >= -1 and o["matches0"].max() < n1
                and o["matches1"].min() >= -1 and o["matches1"].max() < n0,
                "match indices out of range")
        for key in ("matching_scores0", "matching_scores1"):
            sc = o[key]
            require(bool(np.isfinite(sc).all() and (sc >= 0).all()
                         and (sc <= 1 + 1e-6).all()), f"{key} out of [0, 1]")
        if "T" in o and o["T"] is not None:
            require(bool(np.isfinite(o["T"]).all()), "non-finite pose")


def serving(rng, dev, report, counters):
    import torch
    from mdgat_tpu_torch import Matcher

    matcher = Matcher(seed=0, device=dev)
    plain = Matcher(seed=0, device=dev, use_kernels=False)
    cfg = matcher.cfg
    print(f"model: L={cfg.L} D={cfg.descriptor_dim} heads={cfg.num_heads} "
          f"k={cfg.k} sinkhorn_iterations={cfg.sinkhorn_iterations} "
          f"compute={cfg.compute_dtype} rule={cfg.loss_method}")
    requests = [make_pairs(rng, 64) for _ in range(3)]
    reg_pairs = make_pairs(rng, 64)
    matcher.match_batch(requests[0][:2])            # first use: kernel prep
    torch.cuda.synchronize()

    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    outs = [matcher.match_batch(r) for r in requests]
    regs = matcher.register_batch(reg_pairs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    forwards = len(requests) + 1
    print(f"serving: {forwards} forwards of 64 pairs in {wall:.3f} s host "
          f"wall; launches {launches}")
    for name, c in counters.items():
        report[name]["launches"] = launches[name]
    require(launches["eval_layer"] == 36 * forwards,
            f"layer launches {launches['eval_layer']} != 36 per forward")
    require(launches["topk_attention"] == 36 * forwards,
            "attention launches != 36 per forward")
    require(launches["gemm"] == 6 * 36 * forwards, "gemm launches != 216 per forward")
    require(launches["sinkhorn"] == forwards, "sinkhorn launches != 1 per forward")

    for r, o in zip(requests, outs):
        check_outputs(o, r)
    check_outputs(regs, reg_pairs)
    n_pose = sum(o["T"] is not None for o in regs)

    plain_outs = [plain.match_batch(r) for r in requests]
    plain_regs = plain.register_batch(reg_pairs)
    agree = agreement(sum(outs, []) + regs, sum(plain_outs, []) + plain_regs)
    n_matched = sum(int((o["matches0"] >= 0).sum()) for o in sum(outs, []))
    print(f"match agreement kernel vs plain on the card: {agree:.6f} "
          f"(min {MIN_AGREEMENT}); {n_matched} matches0 set; {n_pose} of 64 "
          f"register_batch poses fitted")
    require(agree >= MIN_AGREEMENT, "kernel path disagrees with the plain path")

    cpu = Matcher(seed=0, device="cpu")
    small = make_pairs(rng, 4)
    agree_cpu = agreement(matcher.match_batch(small), cpu.match_batch(small))
    print(f"match agreement kernel path vs CPU path, 4 pairs: {agree_cpu:.6f}")
    require(agree_cpu >= MIN_AGREEMENT, "kernel path disagrees with the CPU path")
    report["_serving"] = dict(forwards=forwards, wall_s=wall,
                              agreement_plain=agree, agreement_cpu=agree_cpu,
                              matches0_set=n_matched, poses=n_pose)
    return matcher, plain, requests[0]


# ---------------------------------------------------------------------------
# phase 5: times
# ---------------------------------------------------------------------------

def timings(rng, dev, report, card, matcher, plain, pairs):
    import torch
    from mdgat_tpu_torch.ops.cuda import attention as A
    from mdgat_tpu_torch.ops.cuda import layer as Lk
    from mdgat_tpu_torch.ops.cuda import sinkhorn as S

    b, h, n, dh = 64, 4, 256, 32
    q, k, v = (torch.from_numpy(rng.normal(size=(b, h, n, dh)).astype(np.float32)).to(dev)
               for _ in range(3))
    mask = ragged_mask(rng, b, n, 200, dev)
    times = {}
    for kk in (128, 64, 0):
        times[f"attention_k{kk}"] = (
            cuda_ms(lambda: A.topk_attention(q, k, v, mask, kk, dh ** -0.5)),
            cuda_ms(lambda: A.topk_attention_reference(q, k, v, mask, kk, dh ** -0.5)))
    layer = _random_layer(7, dev)
    w = layer.kernel_weights()
    x = torch.from_numpy(rng.normal(size=(b, n, 128)).astype(np.float32)).to(dev)
    for kk in (128, 0):
        times[f"layer_k{kk}"] = (
            cuda_ms(lambda: Lk.fused_layer(x, x, mask, kk, w)),
            cuda_ms(lambda: Lk.fused_layer_reference(x, x, mask, kk, w)))
    x2 = x.reshape(b * n, 128)
    times["gemm_q_proj"] = (
        cuda_ms(lambda: Lk.gemm(x2, w.wq, w.bq)),
        cuda_ms(lambda: x2 @ w.wq + w.bq))
    u = torch.relu(torch.from_numpy(rng.normal(size=(b * n, 256)).astype(np.float32)).to(dev))
    times["gemm_mlp2_residual"] = (
        cuda_ms(lambda: Lk.gemm(u, w.w2, w.b2, res=x2)),
        cuda_ms(lambda: x2 + (u @ w.w2 + w.b2)))
    scores = torch.from_numpy(rng.normal(size=(b, n, n)).astype(np.float32)).to(dev)
    times["sinkhorn_64x256x256"] = (
        cuda_ms(lambda: S.log_optimal_transport_kernel(scores, 1.0, 20, mask, mask)),
        cuda_ms(lambda: S.log_optimal_transport_reference(scores, 1.0, 20, mask, mask)))
    big = torch.from_numpy(rng.normal(size=(8, 1024, 1024)).astype(np.float32)).to(dev)
    times["sinkhorn_8x1024x1024"] = (
        cuda_ms(lambda: S.log_optimal_transport_kernel(big, 1.0, 20), reps=5),
        cuda_ms(lambda: S.log_optimal_transport_reference(big, 1.0, 20), reps=5))

    # whole forward on one prepared batch (device only), then the whole
    # match_batch call (host padding, copies, forward, results); in turns
    # plain / kernel / kernel / plain
    batch, _ = matcher.prepare_batch(pairs)
    fwd = {"kernel": [], "plain": [], "kernel_call": [], "plain_call": []}
    for label, m in (("plain", plain), ("kernel", matcher),
                     ("kernel", matcher), ("plain", plain)):
        with torch.inference_mode():
            fwd[label].append(cuda_ms(lambda: m.model(batch), reps=5, warmup=1))
        fwd[label + "_call"].append(
            cuda_ms(lambda: m.match_batch(pairs), reps=3, warmup=1))
    times["forward_64_pairs"] = (min(fwd["kernel"]), min(fwd["plain"]))
    times["match_batch_64_pairs"] = (min(fwd["kernel_call"]),
                                     min(fwd["plain_call"]))

    # the same forward with a bfloat16 GNN (scores and transport in f32)
    from mdgat_tpu_torch import Matcher
    bf = {flag: Matcher(seed=0, device=dev, compute_dtype="bfloat16",
                        use_kernels=flag) for flag in (True, False)}
    with torch.inference_mode():
        times["forward_64_pairs_bf16"] = tuple(
            cuda_ms(lambda: bf[flag].model(batch), reps=5, warmup=1)
            for flag in (True, False))
    agree = agreement(bf[True].match_batch(pairs), bf[False].match_batch(pairs))
    print(f"bf16 forward: match agreement kernel vs plain {agree:.6f} "
          f"(both bf16; the plain path also rounds every product to bf16)")
    report["_serving"]["agreement_plain_bf16"] = agree

    print(f"times on {card} (CUDA events, ms per call; kernel / plain):")
    for key, (t_k, t_p) in times.items():
        print(f"  {key}: {t_k:.4f} / {t_p:.4f}")
    report["topk_attention"].update(ms=times["attention_k128"][0],
                                    plain_ms=times["attention_k128"][1])
    report["eval_layer"].update(ms=times["layer_k128"][0],
                                plain_ms=times["layer_k128"][1])
    report["gemm"].update(ms=times["gemm_mlp2_residual"][0],
                          plain_ms=times["gemm_mlp2_residual"][1])
    report["sinkhorn"].update(ms=times["sinkhorn_64x256x256"][0],
                              plain_ms=times["sinkhorn_64x256x256"][1])
    report["_times_ms"] = {k: {"kernel": a, "plain": p}
                           for k, (a, p) in times.items()}


def profile(matcher, pairs, card):
    """torch.profiler over three kernel-path forwards: device time by
    kernel and the device's busy share of the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    batch, _ = matcher.prepare_batch(pairs)
    with torch.inference_mode():
        matcher.model(batch)
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                matcher.model(batch)
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=25)
    with open(os.path.join(OUT_DIR, "profile.txt"), "w") as f:
        f.write(f"{card}\n{table}\n")
    print(f"profile on {card}: 3 forwards, window {window_ms:.3f} ms host, "
          f"device kernel time {device_ms:.3f} ms, busy share "
          f"{device_ms / window_ms:.3f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d} x  "
              f"{e.key[:90]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from mdgat_tpu_torch.ops.cuda import attention as A
    from mdgat_tpu_torch.ops.cuda import layer as Lk
    from mdgat_tpu_torch.ops.cuda import sinkhorn as S
    from mdgat_tpu_torch.ops.cuda._build import library

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)                      # as nvidia-smi prints it
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"capability {torch.cuda.get_device_capability(0)}")

    t0 = time.perf_counter()
    lib = library()
    print(f"build: {lib.path.name} nvcc {lib.build_seconds:.1f} s, "
          f"load {time.perf_counter() - t0:.1f} s")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "ptxas.log"), "w") as f:
        f.write(lib.ptxas_log)
    regs = [int(w) for w in re.findall(r"Used (\d+) registers", lib.ptxas_log)]
    spills = [int(w) for w in re.findall(r"(\d+) bytes spill stores",
                                          lib.ptxas_log)]
    print(f"ptxas: {len(regs)} kernels, at most {max(regs, default=0)} "
          f"registers a thread, {sum(s > 0 for s in spills)} with spill "
          f"stores (at most {max(spills, default=0)} bytes); full report in "
          f"chip_smoke_out/ptxas.log")

    counters = {"topk_attention": A.topk_attention, "eval_layer": Lk.fused_layer,
                "gemm": Lk.gemm, "sinkhorn": S.log_optimal_transport_kernel}
    report = {
        "topk_attention": dict(route="cuda", source="mdgat_tpu_torch/csrc/attention.cu",
                               replaces="mdgat_tpu/ops/pallas/attention.py:524"),
        "eval_layer": dict(route="cuda", source="mdgat_tpu_torch/csrc/gemm.cu",
                           replaces="mdgat_tpu/ops/pallas/attention.py:577"),
        "gemm": dict(route="cuda", source="mdgat_tpu_torch/csrc/gemm.cu",
                     replaces="mdgat_tpu/ops/pallas/attention.py:577"),
        "sinkhorn": dict(route="cuda", source="mdgat_tpu_torch/csrc/sinkhorn.cu",
                         replaces="mdgat_tpu/ops/pallas/sinkhorn.py:55"),
    }
    rng = np.random.default_rng(0)
    check_attention(rng, dev, report)
    check_layer(rng, dev, report)
    check_sinkhorn(rng, dev, report)
    check_ragged(rng, dev)
    matcher, plain, pairs = serving(rng, dev, report, counters)
    timings(rng, dev, report, card, matcher, plain, pairs)
    profile(matcher, pairs, card)

    kernels = [dict(name=name, **{k: report[name][k] for k in
                                  ("route", "source", "replaces", "launches",
                                   "max_abs_err", "ms", "plain_ms")})
               for name in counters]
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, torch=torch.__version__,
                       cuda=torch.version.cuda, report=report), f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
