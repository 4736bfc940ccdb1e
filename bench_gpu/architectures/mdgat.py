"""MDGAT (Shi et al., RA-L 2021) behind the contract of
``architectures/__init__.py``: the upstream state dict, the plain reference
of ``harness/reference.py``, the work counts of ``harness/work.py`` and the
readings of ``harness/checks.py``, whose arithmetic stays there.

The decision is the gap and triplet losses': each row's and column's
argmax against its dustbin, which competes (dense wins a tie).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from bench_gpu.harness import checks, reference
from bench_gpu.harness import work as counts

# Config fields the program keeps as tuples
TUPLE_FIELDS = ("k", "keypoint_encoder", "descriptor_encoder")


def sizes(config: Dict) -> Dict:
    """The model block and the encoder block (``reference.model_sizes``),
    and ``fine_iters``: the top-k value bisection's passes at the
    configuration's precision."""
    return {**reference.model_sizes(config),
            "fine_iters": config["reference"]["topk_bisection_iters"]}


def param_specs(sizes: Dict):
    return reference.param_specs(sizes)


def gain(name: str, config: Dict) -> float:
    """The configuration's ``weights.final_proj_gain`` on the final
    projection (so that the seeded model's transport is as peaked as a
    trained one's), 1 elsewhere."""
    if name.startswith("final_proj."):
        return config.get("weights", {}).get("final_proj_gain", 1.0)
    return 1.0


def program_fields(config: Dict) -> Dict:
    fields = dict(config["model"])
    for key in TUPLE_FIELDS:
        if fields.get(key) is not None:
            fields[key] = tuple(fields[key])
    return fields


def reference_match(weights, sizes: Dict, x: Dict, prec):
    return reference.match(weights, sizes, x, sizes["fine_iters"], prec)


def reference_train(weights, sizes: Dict, batches, prec, lr: float,
                    loss_rows: Optional[int] = None):
    return reference.train(weights, sizes, batches, sizes["fine_iters"], prec,
                           lr, loss_rows)


def reference_loss(sizes: Dict, transport, x: Dict) -> torch.Tensor:
    """The per-pair gap loss."""
    return reference.gap_loss(*transport, x["gt0"], x["gt1"],
                              sizes["triplet_loss_gamma"], x["mask0"],
                              x["mask1"])


def match_readings(sizes: Dict, answers, masks, transport) -> Dict[str, float]:
    """``match_gap`` and ``score_err`` (``checks.match_readings``)."""
    return checks.match_readings(*answers, *masks, *transport)


def work(sizes: Dict, host: Dict, train: bool) -> Dict[str, float]:
    return counts.summary(sizes, host, train)


def eval_readings(model, x: Dict, dtype, device,
                  reps: int = 3) -> Dict[str, Optional[float]]:
    """``encoder_ms``: device ms of ``MDGAT.encode`` over both clouds of
    one batch, by CUDA events after a warm-up call (None off the card)."""
    if device.type != "cuda":
        return {"encoder_ms": None}
    was = model.training
    model.eval()
    try:
        with torch.no_grad():
            def both():
                model.encode(x, "0", dtype, x.get("mask0"))
                model.encode(x, "1", dtype, x.get("mask1"))
            both()
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                both()
            end.record()
            torch.cuda.synchronize(device)
            return {"encoder_ms": start.elapsed_time(end) / reps}
    finally:
        model.train(was)
