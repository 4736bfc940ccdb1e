"""Point-wise MLP with BatchNorm over the ``[B, N, C]`` layout.

Port of ``mdgat_tpu/ops/mlp.py``. The reference builds every encoder and
propagation MLP from 1x1 ``nn.Conv1d`` + ``BatchNorm1d`` + ReLU stacks
(``models/mdgat.py:34-46``). A 1x1 conv over ``[B, C, N]`` is a per-point
dense layer, so :class:`Conv1x1` keeps the upstream ``Conv1d`` parameter
shapes (weight ``[Cout, Cin, 1]``) and computes ``x @ w[:, :, 0].T + b`` on
``[B, N, C]``. :func:`mlp` is an ``nn.Sequential`` whose state-dict keys
equal the upstream ones (conv at ``3i``, BN at ``3i + 1``), so reference
``.pth`` checkpoints load with ``strict=True``.

BatchNorm follows ``torch.nn.BatchNorm1d`` as the JAX package's
``_batchnorm`` / ``mlp_apply`` do: eps 1e-5; in eval mode the running-stats
affine; in training mode batch statistics over the (batch, points) axes
with the biased variance, and running stats updated with momentum 0.1 and
the unbiased variance. With a validity mask the statistics run over valid
points only, so fixed-shape padding does not move them.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


class Conv1x1(nn.Module):
    """Per-point dense layer with the upstream ``Conv1d(kernel_size=1)``
    parameters (``Conv2d``'s with ``spatial_dims=2``); the weights are cast
    to the activation dtype, as ``conv1x1_apply`` casts them in the JAX
    package."""

    def __init__(self, c_in: int, c_out: int, *, dtype: torch.dtype,
                 device=None, spatial_dims: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            (c_out, c_in) + (1,) * spatial_dims, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.empty(c_out, dtype=dtype, device=device))

    def matrix(self) -> torch.Tensor:
        """The weight as ``[Cout, Cin]``."""
        return self.weight.flatten(1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.matrix().to(x.dtype)
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


class BatchNorm(nn.Module):
    """``BatchNorm1d`` over the channel (last) axis of ``[B, N, C]``;
    parameter and buffer names are ``BatchNorm1d``'s.

    Eval mode: ``(x - mean) * rsqrt(var + eps) * w + b`` on the running
    stats. Training mode (``mlp.py:135-166`` and ``:204-230`` of the JAX
    package): the same affine on the batch mean and the biased two-pass
    variance ``mean((x - mean)^2)``, taken over the points ``valid_mask``
    ``[B, N]`` marks (all of them when it is None; the count is floored at
    1); the running stats move by ``BN_MOMENTUM`` towards the batch mean
    and the unbiased variance ``var * n / max(n - 1, 1)``, in place.
    Padded rows still get (meaningless) outputs, masked downstream."""

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

    def forward(self, x: torch.Tensor,
                valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = x.dtype
        if self.training:
            mean, var = self._batch_stats(x, valid_mask)
        else:
            mean, var = self.running_mean.to(dt), self.running_var.to(dt)
        inv = torch.rsqrt(var + BN_EPS)
        return (x - mean) * inv * self.weight.to(dt) + self.bias.to(dt)

    def _batch_stats(self, x, valid_mask):
        axes = tuple(range(x.dim() - 1))
        if valid_mask is None:
            n = x.numel() // x.shape[-1]
            mean = x.mean(dim=axes)
            var = ((x - mean) ** 2).mean(dim=axes)
            unbias = n / max(n - 1, 1)
        else:
            m = valid_mask[..., None].to(x.dtype)
            cnt = m.sum().clamp_min(1.0)
            mean = (x * m).sum(dim=axes) / cnt
            var = ((x - mean) ** 2 * m).sum(dim=axes) / cnt
            unbias = cnt / (cnt - 1.0).clamp_min(1.0)
        with torch.no_grad():
            rdt = self.running_mean.dtype
            self.running_mean.mul_(1 - BN_MOMENTUM).add_(
                BN_MOMENTUM * mean.detach().to(rdt))
            self.running_var.mul_(1 - BN_MOMENTUM).add_(
                BN_MOMENTUM * (var.detach() * unbias).to(rdt))
            self.num_batches_tracked += 1
        return mean, var

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
            layers.append(BatchNorm(channels[i], dtype=dtype, device=device))
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


def apply_mlp(seq: nn.Sequential, x,
              valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run an :func:`mlp` on ``x`` [..., N, C], or on a tuple of channel
    blocks standing for ``cat(x, -1)``: the first conv is split over the
    blocks (``cat(x) @ w == sum_i x_i @ w_i``) so the concatenation is
    never built, as ``mlp_apply`` does in the JAX package. ``valid_mask``
    [..., N] keeps padded points out of the training-mode BN statistics."""
    layers = list(seq)
    if isinstance(x, (tuple, list)):
        first = layers.pop(0)
        w = first.matrix()
        acc, off = None, 0
        for part in x:
            c = part.shape[-1]
            t = torch.matmul(part, w[:, off:off + c].t().to(part.dtype))
            acc = t if acc is None else acc + t
            off += c
        x = acc + first.bias.to(acc.dtype)
    for layer in layers:
        x = layer(x, valid_mask) if isinstance(layer, BatchNorm) else layer(x)
    return x


def conv_bn_stack(channels: Sequence[int], *, dtype: torch.dtype,
                  device=None) -> Tuple[nn.ModuleList, nn.ModuleList]:
    """The PointNet++ stack over ``channels``: ``Conv2d(1x1)`` layers and
    one BatchNorm for each (``BatchNorm2d``'s names), as the two lists the
    reference keeps them in (``mlp_convs`` / ``mlp_bns``, ``conv_blocks[i]``
    / ``bn_blocks[i]``)."""
    pairs = zip(channels[:-1], channels[1:])
    convs = nn.ModuleList([Conv1x1(a, b, dtype=dtype, device=device,
                                   spatial_dims=2) for a, b in pairs])
    bns = nn.ModuleList([BatchNorm(c, dtype=dtype, device=device)
                         for c in channels[1:]])
    return convs, bns


def apply_conv_bn_stack(convs: nn.ModuleList, bns: nn.ModuleList,
                        x: torch.Tensor) -> torch.Tensor:
    """``relu(bn(conv(x)))`` layer after layer over ``x`` [..., C]. In
    training mode each BN's statistics run over every axis but the channel
    and no point is masked out (``pointnet_util.py:215-217, 337-340``)."""
    for conv, bn in zip(convs, bns):
        x = torch.relu(bn(conv(x)))
    return x
