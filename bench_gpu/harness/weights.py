"""Seeded weights, made where they are served.

One ``torch.rand`` call on the run's device (a ``torch.Generator`` of that
device, seeded from ``--seed``) fills every ``uniform`` tensor of the state
dict at once, in float32, the configuration's parameter dtype; each tensor
is a scaled view of it: U(-1/sqrt(fan_in), 1/sqrt(fan_in)), ``Conv1d`` /
``Conv2d``'s default. After it one ``torch.randn`` call on a second
generator of its own, seeded from the same seed, fills every ``normal``
tensor: N(0, 1) times the spec's scale. A tensor's scale is multiplied by
its architecture's ``gain`` (MDGAT's final projection by the configuration
file's ``weights.final_proj_gain``, so that the seeded model's transport
is as peaked as a trained one's, and its answers mix matches and
dustbins). ``one``, ``zero``, ``bin`` (1) and ``count`` tensors are
constants: BatchNorm starts at the identity and ``bin_score`` at 1, as the
model's own initialisation. The names and shapes are the architecture's
(``param_specs``, the upstream naming), and the program loads them with
``strict=True``, so a tensor the two disagree on fails the load. The same
seed gives the same weights to the program and, made again after the
program is gone, to the reference.
"""

from __future__ import annotations

from typing import Dict

import torch

SEED_MASK = 2 ** 63 - 1
# the normal stream's seed is the run's seed xor this, so that it shares no
# draw with the uniform stream
NORMAL_STREAM = 0x5DEECE66D


def make_weights(config: Dict, seed: int, device,
                 arch) -> Dict[str, torch.Tensor]:
    """The state dict of ``config`` (a configuration file's contents) for
    ``seed``, on ``device``. ``arch`` is the configuration's architecture
    module (``Run.arch``, or ``common.architecture(config)``)."""
    device = torch.device(device)
    specs = arch.param_specs(arch.sizes(config))
    uniform = _draw(specs, "uniform", seed, device)
    normal = _draw(specs, "normal", seed ^ NORMAL_STREAM, device)
    out, off = {}, {"uniform": 0, "normal": 0}
    for name, shape, init, arg in specs:
        if init in off:
            n = _numel(shape)
            flat, scale = ((uniform, arg ** -0.5) if init == "uniform"
                           else (normal, arg))
            scale = scale * arch.gain(name, config)
            out[name] = flat[off[init]:off[init] + n].view(shape) * scale
            off[init] += n
        elif init == "count":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
        else:
            value = 0.0 if init == "zero" else 1.0
            out[name] = torch.full(shape, value, dtype=torch.float32,
                                   device=device)
    return out


def _draw(specs, init: str, seed: int, device) -> torch.Tensor:
    """One flat float32 draw for every ``init`` tensor of ``specs``: U(-1,
    1) for ``uniform``, N(0, 1) for ``normal``."""
    total = sum(_numel(shape) for _, shape, i, _ in specs if i == init)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & SEED_MASK)
    if init == "uniform":
        return torch.rand(total, generator=gen, device=device,
                          dtype=torch.float32).mul_(2.0).sub_(1.0)
    return torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
