"""Point-wise MLP with BatchNorm over the ``[B, N, C]`` layout.

Port of ``mdgat_tpu/ops/mlp.py``. The reference builds every encoder and
propagation MLP from 1x1 ``nn.Conv1d`` + ``BatchNorm1d`` + ReLU stacks
(``models/mdgat.py:34-46``). A 1x1 conv over ``[B, C, N]`` is a per-point
dense layer, so :class:`Conv1x1` keeps the upstream ``Conv1d`` parameter
shapes (weight ``[Cout, Cin, 1]``) and computes ``x @ w[:, :, 0].T + b`` on
``[B, N, C]``. :func:`mlp` is an ``nn.Sequential`` whose state-dict keys
equal the upstream ones (conv at ``3i``, BN at ``3i + 1``), so reference
``.pth`` checkpoints load with ``strict=True``.

BatchNorm here is eval mode only: the running-stats affine with eps 1e-5,
the JAX package's ``mlp_apply(train=False)``. Train-mode BN belongs to the
training slice.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

BN_EPS = 1e-5


class Conv1x1(nn.Module):
    """Per-point dense layer with the upstream ``Conv1d(kernel_size=1)``
    parameters; the weights are cast to the activation dtype, as
    ``conv1x1_apply`` casts them in the JAX package."""

    def __init__(self, c_in: int, c_out: int, *, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(c_out, c_in, 1, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.empty(c_out, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight[:, :, 0].to(x.dtype)
        return torch.matmul(x, w.t()) + self.bias.to(x.dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator,
                         zero_bias: bool = False):
        """``torch.nn.Conv1d``'s default init: kaiming-uniform with
        a=sqrt(5), i.e. U(-1/sqrt(fan_in), 1/sqrt(fan_in)) on weight and
        bias (``ops/mlp.py:72-86`` of the JAX package)."""
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        _uniform_(self.weight, bound, generator)
        if zero_bias:
            self.bias.zero_()
        else:
            _uniform_(self.bias, bound, generator)


def _uniform_(t: torch.Tensor, bound: float, generator: torch.Generator):
    # draw on the CPU generator in float64, then cast: the numbers do not
    # depend on the parameter's device or dtype
    u = torch.rand(t.shape, generator=generator, dtype=torch.float64)
    t.copy_((u * 2.0 - 1.0) * bound)


class BatchNormEval(nn.Module):
    """``BatchNorm1d`` over the channel (last) axis of ``[B, N, C]`` with
    its running-stats affine: ``(x - mean) * rsqrt(var + eps) * w + b``.
    Parameter and buffer names are ``BatchNorm1d``'s."""

    def __init__(self, c: int, *, dtype: torch.dtype, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(c, dtype=dtype, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(c, dtype=dtype, device=device))
        self.register_buffer("running_var",
                             torch.ones(c, dtype=dtype, device=device))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.int64, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        inv = torch.rsqrt(self.running_var.to(dt) + BN_EPS)
        return ((x - self.running_mean.to(dt)) * inv * self.weight.to(dt)
                + self.bias.to(dt))

    def fold_scale(self, dtype: torch.dtype) -> torch.Tensor:
        """``weight / sqrt(var + eps)``: ``bn(h) == (h - mean) * f + bias``."""
        return (self.weight.to(dtype)
                / torch.sqrt(self.running_var.to(dtype) + BN_EPS))


def mlp(channels: Sequence[int], *, dtype: torch.dtype,
        device=None) -> nn.Sequential:
    """MLP(channels) of ``models/mdgat.py:34-46``: conv, BN, ReLU on every
    layer but the last, which is a bare conv."""
    layers = []
    n = len(channels)
    for i in range(1, n):
        layers.append(Conv1x1(channels[i - 1], channels[i], dtype=dtype,
                              device=device))
        if i < n - 1:
            layers.append(BatchNormEval(channels[i], dtype=dtype,
                                        device=device))
            layers.append(nn.ReLU())
    return nn.Sequential(*layers)


def reset_mlp(seq: nn.Sequential, generator: torch.Generator,
              zero_last_bias: bool = False):
    """Seeded init of an :func:`mlp`; ``zero_last_bias`` reproduces the
    reference's ``nn.init.constant_(encoder[-1].bias, 0.0)``."""
    convs = [m for m in seq if isinstance(m, Conv1x1)]
    for i, conv in enumerate(convs):
        conv.reset_parameters(generator,
                              zero_bias=zero_last_bias and i == len(convs) - 1)


def apply_mlp(seq: nn.Sequential, x) -> torch.Tensor:
    """Run an :func:`mlp` on ``x`` [..., N, C], or on a tuple of channel
    blocks standing for ``cat(x, -1)``: the first conv is split over the
    blocks (``cat(x) @ w == sum_i x_i @ w_i``) so the concatenation is
    never built, as ``mlp_apply`` does in the JAX package."""
    layers = list(seq)
    if isinstance(x, (tuple, list)):
        first = layers.pop(0)
        w = first.weight[:, :, 0]
        acc, off = None, 0
        for part in x:
            c = part.shape[-1]
            t = torch.matmul(part, w[:, off:off + c].t().to(part.dtype))
            acc = t if acc is None else acc + t
            off += c
        x = acc + first.bias.to(acc.dtype)
    for layer in layers:
        x = layer(x)
    return x
