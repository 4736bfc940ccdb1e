"""Seeded weights, made where they are served.

One ``torch.rand`` call on the run's device (a ``torch.Generator`` of that
device, seeded from ``--seed``) fills every initialised tensor of the state
dict at once, in float32, the configuration's parameter dtype; each tensor
is a scaled view of it. Weights and biases are ``Conv1d`` / ``Conv2d``'s
default U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the final projection's scaled
by the configuration file's ``weights.final_proj_gain`` (so that the
seeded model's transport is as peaked as a trained one's, and its answers
mix matches and dustbins); BatchNorm starts at the identity and
``bin_score`` at 1, as the model's own initialisation. The
names and shapes are the reference's (:func:`reference.param_specs`, the
upstream naming), and the program loads them with ``strict=True``, so a
tensor the two disagree on fails the load. The same seed gives the same
weights to the program and, made again after the program is gone, to the
reference.
"""

from __future__ import annotations

from typing import Dict

import torch

from bench_gpu.harness.reference import model_sizes, param_specs


def make_weights(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of ``config`` (a configuration file's contents) for
    ``seed``, on ``device``."""
    device = torch.device(device)
    specs = param_specs(model_sizes(config))
    gain = config.get("weights", {}).get("final_proj_gain", 1.0)
    total = sum(_numel(shape) for _, shape, init, _ in specs
                if init == "uniform")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & (2 ** 63 - 1))
    flat = torch.rand(total, generator=gen, device=device,
                      dtype=torch.float32).mul_(2.0).sub_(1.0)
    out, off = {}, 0
    for name, shape, init, fan_in in specs:
        if init == "uniform":
            n = _numel(shape)
            scale = fan_in ** -0.5 * (gain if name.startswith("final_proj.")
                                      else 1.0)
            out[name] = flat[off:off + n].view(shape) * scale
            off += n
        elif init == "count":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
        else:
            value = 0.0 if init == "zero" else 1.0
            out[name] = torch.full(shape, value, dtype=torch.float32,
                                   device=device)
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
