#!/usr/bin/env python3
"""Match agreement of the attention kernel's two top-k arms on the card.

The port's counterpart of ``tools/measure_topk_agreement.py``. The serving
forward of the flagship model (seeded weights or ``--checkpoint``,
``Matcher``) runs on the
same seeded synthetic pairs (``chip_smoke.make_pairs``: 200-256 keypoints a
cloud, batches of 64) three ways:

* ``fast``: the kernel route with the fast arm (value bisection, the
  default of ``Config.exact_topk=False``);
* ``exact``: the kernel route with the exact arm;
* ``plain``: the plain PyTorch route, which selects the exact top-k.

A flip is a match slot (an entry of ``matches0`` or ``matches1``) where two
runs differ. ``exact`` against ``plain`` is the score-noise floor: the same
selection rule on scores summed in other orders. The fast arm's own cost is
``fast`` against ``exact``; the JAX package's rule is that it must not
exceed the floor. Precision and recall are against the pairs' known
correspondences (cloud 1's first points are cloud 0's, moved).

    python3 tools/torch_topk_agreement.py                    # f32 and bf16
    python3 tools/torch_topk_agreement.py --batches 4 --iters 3 4 5 14

``--iters`` overrides the fast arm's resolution (binary passes; 0 is the
dtype's default, ``ops/attention.py::fast_iters``). The last line of the
output is a JSON object of every row.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def truth(pair):
    """``matches0`` of the pair's known correspondences (``make_pairs``)."""
    n0, n1 = len(pair["kp0"]), len(pair["kp1"])
    shared = int(0.7 * min(n0, n1))
    gt = np.full(n0, -1)
    gt[:shared] = np.arange(shared)
    return gt


def precision_recall(outs, pairs):
    hit = said = real = 0
    for o, p in zip(outs, pairs):
        gt = truth(p)
        m = o["matches0"]
        said += int((m >= 0).sum())
        real += int((gt >= 0).sum())
        hit += int(((m >= 0) & (m == gt)).sum())
    return hit / max(said, 1), hit / max(real, 1)


def flips(outs_a, outs_b):
    return sum(int((a[key] != b[key]).sum()) for a, b in zip(outs_a, outs_b)
               for key in ("matches0", "matches1"))


def measure(dtypes=("float32", "bfloat16"), iters=(0,), batches: int = 4,
            batch: int = 64, seed: int = 0, device: str = "cuda",
            checkpoint=None):
    """Rows of ``dict(dtype, iters, slots, flips_fast_exact,
    flips_exact_plain, flips_fast_plain, precision/recall of each arm)``,
    one a dtype and resolution; ``iters`` 0 is the dtype's default. The
    model has seeded weights, or those of ``checkpoint``."""
    import torch
    from chip_smoke import make_pairs
    from mdgat_tpu_torch import Matcher
    from mdgat_tpu_torch.ops import attention as plain_attention

    rng = np.random.default_rng(seed)
    requests = [make_pairs(rng, batch) for _ in range(batches)]
    pairs = sum(requests, [])
    slots = sum(len(p["kp0"]) + len(p["kp1"]) for p in pairs)
    rows = []
    defaults = {name: getattr(plain_attention, name) for name in
                ("FAST_ITERS_BF16", "FAST_ITERS_F32", "FAST_ITERS_OTHER")}
    for dt in dtypes:
        kw = dict(device=device, compute_dtype=dt)
        if checkpoint is None:
            kw["seed"] = 0
        else:
            kw["checkpoint"] = checkpoint
        runs = {"exact": Matcher(exact_topk=True, **kw),
                "plain": Matcher(use_kernels=False, **kw)}
        outs = {name: sum((m.match_batch(r) for r in requests), [])
                for name, m in runs.items()}
        fast = Matcher(exact_topk=False, **kw)
        torch_dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dt]
        for it in iters:
            try:
                if it:
                    for name in defaults:
                        setattr(plain_attention, name, int(it))
                resolution = plain_attention.fast_iters(torch_dt)
                outs["fast"] = sum((fast.match_batch(r) for r in requests), [])
            finally:
                for name, value in defaults.items():
                    setattr(plain_attention, name, value)
            row = dict(dtype=dt, iters=resolution, pairs=len(pairs),
                       weights=(os.path.basename(checkpoint) if checkpoint
                                else "seed 0"),
                       slots=slots,
                       flips_fast_exact=flips(outs["fast"], outs["exact"]),
                       flips_exact_plain=flips(outs["exact"], outs["plain"]),
                       flips_fast_plain=flips(outs["fast"], outs["plain"]))
            for name in ("fast", "exact", "plain"):
                row[f"precision_{name}"], row[f"recall_{name}"] = \
                    precision_recall(outs[name], pairs)
            row["precision_delta"] = row["precision_fast"] - row["precision_exact"]
            row["recall_delta"] = row["recall_fast"] - row["recall_exact"]
            rows.append(row)
        del runs, fast
        torch.cuda.empty_cache()
    return rows


def describe(row) -> str:
    return (f"{row['dtype']} iters {row['iters']} ({row['weights']}): flips "
            f"fast/exact "
            f"{row['flips_fast_exact']}, exact/plain {row['flips_exact_plain']}"
            f" (the floor), fast/plain {row['flips_fast_plain']} of "
            f"{row['slots']} slots ({row['pairs']} pairs); precision "
            f"{row['precision_fast']:.6f} / {row['precision_exact']:.6f} / "
            f"{row['precision_plain']:.6f}, recall {row['recall_fast']:.6f} "
            f"/ {row['recall_exact']:.6f} / {row['recall_plain']:.6f} "
            f"(fast / exact / plain)")


def main(argv=None) -> int:
    import torch
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dtypes", nargs="+", default=["float32", "bfloat16"],
                   choices=["float32", "bfloat16"])
    p.add_argument("--iters", nargs="+", type=int, default=[0])
    p.add_argument("--batches", type=int, default=4)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint", default=None,
                   help="a .pth or .npz of the model; default seeded weights")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_topk_agreement: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = measure(args.dtypes, args.iters, args.batches, args.batch,
                   args.seed, checkpoint=args.checkpoint)
    for row in rows:
        print(describe(row))
    print(json.dumps({"rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
