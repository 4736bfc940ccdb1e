"""Weights for the port: the JAX package's trees, its ``.npz`` files and
reference ``.pth`` files, all as state dicts with the upstream key names.

* :func:`state_dict_from_numpy` turns the JAX package's ``(params,
  bn_state)`` trees, given as numpy arrays, into the port's state dict. It
  mirrors ``mdgat_tpu/core/checkpoint.py::export_pth_state_dict`` without
  importing JAX: dense kernels ``[in, out]`` become ``Conv1d`` weights
  ``[out, in, 1]``, BN scale/bias/running stats map to ``BatchNorm1d``'s
  names, and ``num_batches_tracked`` is 0.
* :func:`load_npz` reads a native ``.npz`` checkpoint (flat ``group::a/b/0``
  keys) back into those trees with numpy alone, as ``load_checkpoint`` +
  ``flat_to_tree`` do.
* :func:`load_pth_state_dict` reads a reference ``.pth`` (a training
  checkpoint with ``net``, or a bare state dict) and strips DataParallel's
  ``module.`` prefix.

Load any of them with ``model.load_state_dict(sd, strict=True)``.

Training checkpoints are the reference's ``.pth`` with its five fields
(``train.py:288-294``): ``net`` (``module.``-prefixed keys, as DataParallel
writes them), ``optimizer`` (``Adam.state_dict()``, moments included),
``epoch``, ``lr_schedule`` and ``loss``. :func:`save_train_checkpoint`
writes one from a ``TrainState``; :func:`load_train_checkpoint` resumes
one, either with the saved moments, so that the next step is the one the
saved run would have taken, or as the reference does (``train.py:160-163,
203``): weights only, under a fresh Adam at the checkpointed learning rate.

The way back to the JAX package for a trained step needs no second
function: ``state_dict_from_numpy`` applied to a JAX tree of parameters,
gradients or updated parameters (numpy leaves) names it like the port's
``named_parameters()``, and the tests compare under those names.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Tuple

import numpy as np
import torch

_NONE_SENTINEL = "__none__"


def _conv(p, prefix: str, out: Dict[str, torch.Tensor]):
    w = np.asarray(p["w"])
    out[f"{prefix}.weight"] = torch.from_numpy(
        np.array(w.T[:, :, None], order="C"))
    out[f"{prefix}.bias"] = torch.from_numpy(np.array(p["b"]))


def _mlp(params, state, prefix: str, out: Dict[str, torch.Tensor]):
    """One reference MLP stack: conv at 3i, BN at 3i+1 on every non-last
    layer."""
    for i, layer in enumerate(params):
        pos = 3 * i
        _conv(layer["lin"], f"{prefix}.{pos}", out)
        if "bn" in layer:
            bn = f"{prefix}.{pos + 1}"
            out[f"{bn}.weight"] = torch.from_numpy(np.array(layer["bn"]["scale"]))
            out[f"{bn}.bias"] = torch.from_numpy(np.array(layer["bn"]["bias"]))
            out[f"{bn}.running_mean"] = torch.from_numpy(np.array(state[i]["mean"]))
            out[f"{bn}.running_var"] = torch.from_numpy(np.array(state[i]["var"]))
            out[f"{bn}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)


def propagation_state_dict(layer, layer_state) -> Dict[str, torch.Tensor]:
    """One GNN layer's trees (``attentional_propagation_init`` layout) ->
    the state dict of an ``AttentionalPropagation``."""
    out: Dict[str, torch.Tensor] = {}
    for j, name in enumerate(("q", "k", "v")):
        _conv(layer["attn"][name], f"attn.proj.{j}", out)
    _conv(layer["attn"]["merge"], "attn.merge", out)
    _mlp(layer["mlp"], layer_state["mlp"], "mlp", out)
    return out


def state_dict_from_numpy(params, bn_state, config) -> Dict[str, torch.Tensor]:
    """JAX package trees (numpy leaves) -> the port's state dict."""
    if config.descriptor != "FPFH":
        raise NotImplementedError(
            f"descriptor {config.descriptor!r}: the port runs FPFH only")
    out: Dict[str, torch.Tensor] = {}
    _mlp(params["kenc"]["mlp"], bn_state["kenc"]["mlp"], "kenc.encoder", out)
    _mlp(params["denc"]["mlp"], bn_state["denc"]["mlp"], "denc.encoder", out)
    for i, (layer, lstate) in enumerate(zip(params["gnn"], bn_state["gnn"])):
        for k, v in propagation_state_dict(layer, lstate).items():
            out[f"gnn.layers.{i}.{k}"] = v
    _conv(params["final_proj"], "final_proj", out)
    out["bin_score"] = torch.from_numpy(
        np.array(params["bin_score"]).reshape(()))
    return out


def _flat_to_tree(flat: Dict[str, np.ndarray]):
    """Nested dicts/lists from ``a/b/0`` path keys (digit segments are list
    indices; the ``__none__`` sentinel is None)."""
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            if (isinstance(node, np.ndarray) and node.dtype.kind == "U"
                    and node.ndim == 0 and str(node) == _NONE_SENTINEL):
                return None
            return node
        keys = list(node.keys())
        if keys and all(re.fullmatch(r"\d+", k) for k in keys):
            return [listify(node[str(i)]) for i in sorted(int(k) for k in keys)]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def load_npz(path: str) -> Tuple[Any, Any, Dict[str, Any]]:
    """A native ``.npz`` checkpoint -> (params, bn_state, meta)."""
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    meta: Dict[str, Any] = {}
    with np.load(path if path.endswith(".npz") else path + ".npz",
                 allow_pickle=False) as data:
        for key in data.files:
            group, sub = key.split("::", 1)
            if group == "meta":
                meta[sub] = data[key].item()
            else:
                groups.setdefault(group, {})[sub] = data[key]
    return (_flat_to_tree(groups["params"]), _flat_to_tree(groups["bn_state"]),
            meta)


def load_pth_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` (``{net, optimizer, epoch, ...}`` or a bare
    state dict) -> state dict without the ``module.`` prefix."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt["net"] if "net" in ckpt else ckpt
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in sd.items()}


def save_train_checkpoint(path: str, state, epoch: int = 0,
                          loss: float = 0.0) -> None:
    """Write ``state`` (a ``TrainState``) as a reference-layout ``.pth``."""
    lr = float(state.optimizer.param_groups[0]["lr"])
    net = {f"module.{k}": v.detach().cpu()
           for k, v in state.model.state_dict().items()}
    torch.save({"net": net, "optimizer": state.optimizer.state_dict(),
                "epoch": int(epoch), "lr_schedule": lr, "loss": float(loss)},
               path)


def load_train_checkpoint(path: str, state, fresh_optimizer: bool = False
                          ) -> Dict[str, Any]:
    """Resume ``state`` in place from a training ``.pth``; returns
    ``{epoch, lr_schedule, loss}``. By default the optimizer state is
    restored too (moments and step counts; a reference checkpoint carries
    them as well). ``fresh_optimizer`` reproduces the reference's resume
    instead: a new Adam at the checkpointed learning rate."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(
        {(k[len("module."):] if k.startswith("module.") else k): v
         for k, v in ckpt["net"].items()}, strict=True)
    lr = float(ckpt.get("lr_schedule", 0.0))
    if fresh_optimizer or not ckpt["optimizer"].get("state"):
        state.optimizer = torch.optim.Adam(state.model.parameters(), lr=lr)
        state.step = 0
    else:
        state.optimizer.load_state_dict(ckpt["optimizer"])
        steps = [int(s["step"]) for s in state.optimizer.state.values()]
        state.step = max(steps, default=0)
    return {"epoch": int(ckpt.get("epoch", 0)), "lr_schedule": lr,
            "loss": float(ckpt.get("loss", 0.0))}
