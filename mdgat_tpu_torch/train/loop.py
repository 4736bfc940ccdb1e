"""Train and eval steps: the reference train loop's core.

Port of ``mdgat_tpu/train/loop.py`` (reference ``train.py:219-312``): Adam
at lr 1e-4 over all parameters, loss = mean of the per-example loss vector,
metrics ``loss`` and ``grad_norm`` (the global L2 norm of the gradients).

``torch.optim.Adam`` with its defaults is ``optax.adam``: b1 0.9, b2 0.999,
eps 1e-8 added outside the square root, bias correction on both moments, no
weight decay, no amsgrad. The two write the update differently
(``lr / c1 * m / (sqrt(v) / sqrt(c2) + eps)`` against ``lr * (m / c1) /
(sqrt(v / c2) + eps)``), which is the same number up to rounding.

Where JAX threads an immutable ``TrainState`` through a jitted function,
the port's state owns the module and the optimizer and a step updates them
in place. The step runs where the state was created: ``device`` is
explicit, a CUDA device that is not there raises, and TF32 is switched off
on the card as ``Matcher`` does. With ``config.use_kernels`` on a CUDA
device a step launches, per GNN layer and cloud, the whole-layer train
kernels forward and backward (``config.train_layer``, the default; without
it the fused-MHA pair, with the layer's MLP and BatchNorm plain), and the
Sinkhorn forward and replay-backward kernels once each; the encoders, the
score product and the loss are plain PyTorch under autograd.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from mdgat_tpu_torch.core.config import Config
from mdgat_tpu_torch.models.mdgat import MDGAT


@dataclasses.dataclass
class TrainState:
    model: MDGAT
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_train_state(config: Config, *, device, seed: Optional[int] = None,
                       learning_rate: Optional[float] = None,
                       state_dict: Optional[Dict[str, torch.Tensor]] = None
                       ) -> TrainState:
    """A model on ``device`` ("cpu", "cuda", ...) with seeded weights
    (``seed``) or loaded ones (``state_dict``, upstream key names), and
    Adam at ``learning_rate`` (default ``config.learning_rate``)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("create_train_state(device='cuda'): no CUDA "
                               "device")
        # full-precision f32 products on the card (TF32 keeps ~3 digits)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    model = MDGAT(config)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    elif seed is not None:
        model.reset_parameters(seed)
    else:
        raise ValueError("pass a seed or a state_dict")
    model.to(device)
    lr = config.learning_rate if learning_rate is None else learning_rate
    return TrainState(model, torch.optim.Adam(model.parameters(), lr=lr))


def make_train_step() -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Returns ``step(state, batch) -> (state, metrics)``. ``batch`` holds
    the model's inputs with ground truth, on the model's device; the state
    is updated in place. ``metrics`` are 0-dim tensors on the device
    (reading one waits for the step)."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model, opt = state.model, state.optimizer
        model.train()
        opt.zero_grad(set_to_none=True)
        loss = model(batch)["loss"].mean()
        loss.backward()
        grad_norm = torch.nn.utils.get_total_norm(
            [p.grad for p in model.parameters() if p.grad is not None])
        opt.step()
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm}

    return step


def make_eval_step(model: MDGAT) -> Callable[[Dict[str, torch.Tensor]],
                                             Dict[str, torch.Tensor]]:
    """Returns ``step(batch) -> outputs`` in eval mode (running-stats BN),
    without gradients; the module's mode is put back afterwards."""

    def step(batch: Dict[str, torch.Tensor]):
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                return model(batch)
        finally:
            model.train(was_training)

    return step
