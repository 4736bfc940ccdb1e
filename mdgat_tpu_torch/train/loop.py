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

Where the JAX package jits its steps, the port captures them
(``utils/graphs.py``): on a CUDA model with ``use_kernels`` and
``cuda_graphs`` (the defaults) the whole train step (forward,
``loss.backward()``, ``grad_norm`` and Adam's update) and the eval forward
run through a :class:`~mdgat_tpu_torch.utils.graphs.Captured`: eagerly the
first time a batch shape is seen, captured as a CUDA graph the second, and
replayed after that. For that the optimizer is Adam with
``capturable=True`` on the card (:func:`make_optimizer`; its step count
is a device tensor), and the gradient buffers stay where they are from
step to step (``zero_grad(set_to_none=False)``). The outputs of a replay
are clones. Data-parallel and seq-parallel steps stay eager.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from mdgat_tpu_torch.core.config import Config
from mdgat_tpu_torch.models.factory import build_model
from mdgat_tpu_torch.models.mdgat import MDGAT
from mdgat_tpu_torch.ops.cuda.sinkhorn import planned_pairs
from mdgat_tpu_torch.utils.graphs import Captured, use_graphs
from mdgat_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class TrainState:
    model: MDGAT
    optimizer: torch.optim.Optimizer
    step: int = 0
    # the captured train steps of this model and optimizer (make_train_step)
    graphs: Optional[Captured] = dataclasses.field(default=None, repr=False)


def make_optimizer(model: MDGAT, lr: float, device) -> torch.optim.Adam:
    """Adam at ``lr`` over ``model``'s parameters, ``optax.adam``'s
    constants. On a CUDA device it is capturable (its step count a device
    tensor, its bias corrections computed on the card), so that a CUDA
    graph can hold its update, with the multi-tensor kernels; on the CPU
    it is ``torch.optim.Adam``'s default. ``create_train_state`` and
    ``core/checkpoint.py::load_train_checkpoint`` both build it here."""
    if torch.device(device).type != "cuda":
        return torch.optim.Adam(model.parameters(), lr=lr)
    opt = torch.optim.Adam(model.parameters(), lr=lr, capturable=True,
                           foreach=True)
    # eager steps (cuda_graphs=False, --debug_nans) are meant: no warning
    opt._warned_capturable_if_run_uncaptured = True
    return opt


def create_train_state(config: Config, *, device, seed: Optional[int] = None,
                       learning_rate: Optional[float] = None,
                       state_dict: Optional[Dict[str, torch.Tensor]] = None
                       ) -> TrainState:
    """A model on ``device`` ("cpu", "cuda", ...) with seeded weights
    (``seed``) or loaded ones (``state_dict``, upstream key names), and
    Adam at ``learning_rate`` (default ``config.learning_rate``). The
    model comes from ``models/factory.py::build_model``; ``net="lightglue"``
    raises ``ValueError`` (no LightGlue loss is ported)."""
    if config.net == "lightglue":
        raise ValueError("net lightglue has no loss here: it serves through "
                         "Matcher(net='lightglue') and cannot be trained")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("create_train_state(device='cuda'): no CUDA "
                               "device")
        # full-precision f32 products on the card (TF32 keeps ~3 digits)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    model = build_model(config)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    elif seed is not None:
        model.reset_parameters(seed)
    else:
        raise ValueError("pass a seed or a state_dict")
    model.to(device)
    lr = config.learning_rate if learning_rate is None else learning_rate
    return TrainState(model, make_optimizer(model, lr, device))


def make_train_step(group=None) -> Callable[
        [TrainState, Dict[str, torch.Tensor]],
        Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Returns ``step(state, batch) -> (state, metrics)``. ``batch`` holds
    the model's inputs with ground truth, on the model's device; the state
    is updated in place. ``metrics`` are 0-dim tensors on the device
    (reading one waits for the step). Where ``utils/graphs.py::use_graphs``
    says so the step is captured per batch shape into ``state.graphs``
    (the module docstring). With ``group`` (a ``parallel.DataParallelGroup``)
    ``batch`` is this rank's share of the global batch and the step is
    ``parallel/smap.py::make_data_parallel_train_step``'s, eager."""
    if group is not None:
        from mdgat_tpu_torch.parallel.smap import make_data_parallel_train_step
        return make_data_parallel_train_step(group)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        with span("mdgat.entry.train_step", state.step):
            model = state.model
            model.train()
            if use_graphs(model.config, model.bin_score.device, batch):
                if state.graphs is None:
                    state.graphs = Captured(lambda b: _train_step(state, b))
                metrics = state.graphs(batch, key=(
                    "train", id(model), id(state.optimizer), planned_pairs(),
                    model.config.exact_topk))
                # a replay updated the parameters without bumping their
                # versions: the eval layers' cached kernel weights are stale
                model.gnn.forget_kernel_weights()
            else:
                metrics = _train_step(state, batch)
        state.step += 1
        return state, metrics

    return step


def _train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
    """One update of ``state`` in place: forward, backward, the gradients'
    global norm and Adam's step; ``{loss, grad_norm}``. The gradient
    buffers are zeroed where they are, not dropped, so that a captured
    step finds them at the same addresses."""
    model, opt = state.model, state.optimizer
    opt.zero_grad(set_to_none=False)
    loss = model(batch)["loss"].mean()
    loss.backward()
    grad_norm = torch.nn.utils.get_total_norm(
        [p.grad for p in model.parameters() if p.grad is not None])
    opt.step()
    return {"loss": loss.detach(), "grad_norm": grad_norm}


def make_eval_step(model: MDGAT, seq_group=None) -> Callable[
        [Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """Returns ``step(batch) -> outputs`` in eval mode (running-stats BN),
    without gradients; the module's mode is put back afterwards. Where
    ``utils/graphs.py::use_graphs`` says so the forward is captured per
    batch shape (and Sinkhorn plan), and each replay folds the layers'
    kernel weights anew from the live parameters. With ``seq_group``
    (``DataParallelGroup.seq_group``) ``batch`` is this seq member's
    keypoint block and the outputs are those of the whole clouds: the eval
    step of ``make_shard_map_eval_step`` on a seq axis, eager."""

    def forward(batch):
        with torch.no_grad():
            return model(batch, seq_group=seq_group)

    captured = Captured(forward)

    def step(batch: Dict[str, torch.Tensor]):
        with span("mdgat.entry.eval_step"):
            was_training = model.training
            model.eval()
            try:
                if seq_group is None and use_graphs(
                        model.config, model.bin_score.device, batch):
                    return captured(batch, key=("eval", planned_pairs(),
                                                model.config.exact_topk))
                return forward(batch)
            finally:
                model.train(was_training)

    step.graphs = captured
    return step
