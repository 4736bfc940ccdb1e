"""Port parity of the training slice as a whole: ``make_train_step`` of
``mdgat_tpu_torch.train.loop`` against ``mdgat_tpu.train.make_train_step``
from the same weights on the same synthetic batch (unequal keypoint counts,
masks on): loss, ``grad_norm``, every gradient, every updated parameter and
every BatchNorm running statistic, after one step and after three, for each
of the three losses at batch 4; and save -> resume -> the same next step.

The JAX package runs with every Pallas kernel off at float64 (tight
tolerances), and at float32 as each of the port's two kernel routes is laid
out, in interpret mode with exact top-k: at its default routing (whole-layer
train kernels, ``pallas_train_layer=True``) against the port's default
``train_layer=True``, and with ``pallas_train_layer=False`` (fused-MHA and
Sinkhorn kernel pairs) against ``train_layer=False``. The port's two routes
are also held against each other at float64.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from mdgat_tpu.core.config import train_defaults as jax_train_defaults
from mdgat_tpu.models import MDGAT as JaxMDGAT
from mdgat_tpu.train import make_train_step as jax_make_train_step
from mdgat_tpu.train.loop import TrainState as JaxTrainState

from mdgat_tpu_torch.core.checkpoint import (load_train_checkpoint,
                                             save_train_checkpoint,
                                             state_dict_from_numpy)
from mdgat_tpu_torch.core.config import train_defaults as port_train_defaults
from mdgat_tpu_torch.data.pipeline import (collate_pairs, model_inputs,
                                           prepare_batch)
from mdgat_tpu_torch.data.synthetic import make_synthetic_pair
from mdgat_tpu_torch.train import (create_train_state, make_eval_step,
                                   make_train_step)

TINY = dict(L=2, k=(8, None), descriptor_dim=32, keypoint_encoder=(16, 32),
            descriptor_encoder=(16,), sinkhorn_iterations=5, batch_size=4)
LR = 1e-3
SIZES = [(40, 36), (30, 44), (48, 25), (33, 41)]
# below this a float32 gradient entry of these models is rounding noise
# around an exact zero: the non-zero entries start at about 1e-6 and the
# kernel path's gradients differ from the plain path's by at most 3e-7
NOISE_GRAD = 1e-6


def _weights(dtype, **over):
    """JAX-initialised trees as numpy with random BN affines and running
    stats, a non-zero final bias in every MLP and a non-default bin score."""
    cfg = jax_train_defaults(**{**TINY, **over}, param_dtype=dtype,
                             compute_dtype=dtype)
    params, state = JaxMDGAT(cfg).init(jax.random.PRNGKey(11))
    params = jax.tree.map(lambda a: np.array(a), params)
    state = jax.tree.map(lambda a: np.array(a), state)
    rng = np.random.default_rng(1300)

    def randomise(p_layers, s_layers):
        for p, s in zip(p_layers, s_layers):
            if "bn" in p:
                c = p["bn"]["scale"].shape[0]
                p["bn"] = {"scale": rng.uniform(0.5, 1.5, c).astype(dtype),
                           "bias": (rng.normal(size=c) * 0.2).astype(dtype)}
                s.update(mean=(rng.normal(size=c) * 0.3).astype(dtype),
                         var=rng.uniform(0.5, 1.5, c).astype(dtype))
        last = p_layers[-1]["lin"]
        last["b"] = (rng.normal(size=last["b"].shape) * 0.1).astype(dtype)

    randomise(params["kenc"]["mlp"], state["kenc"]["mlp"])
    randomise(params["denc"]["mlp"], state["denc"]["mlp"])
    for p, s in zip(params["gnn"], state["gnn"]):
        randomise(p["mlp"], s["mlp"])
    params["bin_score"] = np.asarray(0.6, dtype)
    return params, state


def _batch(dtype):
    rng = np.random.default_rng(1301)
    pairs = []
    for n0, n1 in SIZES:
        p = make_synthetic_pair(rng, n_points=max(n0, n1), overlap=0.8,
                                jitter=0.02, desc_noise=0.02)
        for key in ("kp0", "desc0", "score0"):
            p[key] = p[key][:n0]
        for key in ("kp1", "desc1", "score1"):
            p[key] = p[key][:n1]
        pairs.append(p)
    tdt = torch.float64 if dtype == "float64" else torch.float32
    batch = model_inputs(prepare_batch(
        collate_pairs(pairs, dtype=np.dtype(dtype), bucket=16), 0.5, False,
        "cpu", tdt, tdt))
    assert batch["keypoints0"].shape == (4, 48, 3)
    assert int((batch["gt_matches0"] >= 0).sum()) > 40
    return batch


def _run_port(pcfg, params, bn_state, batch, steps):
    pstate = create_train_state(
        pcfg, device="cpu", learning_rate=LR,
        state_dict=state_dict_from_numpy(params, bn_state, pcfg))
    pstep = make_train_step()
    got = dict(metrics=[])
    for i in range(steps):
        pstate, m = pstep(pstate, batch)
        got["metrics"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            got["grads"] = {k: p.grad.clone()
                            for k, p in pstate.model.named_parameters()}
    got["state"] = pstate.model.state_dict()
    assert pstate.step == steps
    return got


def _run_both(loss_method, dtype, steps, over=None, port_flags=None,
              **jax_flags):
    """(per-step metrics, gradients of step 1, final parameters and BN
    stats) of both packages, the JAX side named like the port's."""
    tiny = {**TINY, **(over or {})}
    params, bn_state = _weights(dtype, **(over or {}))
    batch = _batch(dtype)
    jcfg = jax_train_defaults(**tiny, loss_method=loss_method,
                              param_dtype=dtype, compute_dtype=dtype,
                              **jax_flags)
    pcfg = port_train_defaults(**tiny, loss_method=loss_method,
                               param_dtype=dtype, compute_dtype=dtype,
                               **(port_flags or {}))
    jmodel = JaxMDGAT(jcfg)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    # the first link keeps the step's gradients in its state, so one
    # compiled step yields them too
    keep = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda u, s, p=None: (u, u))
    tx = optax.chain(keep, optax.adam(LR))
    jp = jax.tree.map(jnp.asarray, params)
    js = jax.tree.map(jnp.asarray, bn_state)
    jstate = JaxTrainState(jp, js, tx.init(jp), jnp.zeros((), jnp.int32))
    jstep = jax_make_train_step(jmodel, tx, donate=False)

    want = dict(metrics=[])
    for i in range(steps):
        jstate, m = jstep(jstate, jbatch)
        want["metrics"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            want["grads"] = state_dict_from_numpy(
                jax.tree.map(np.asarray, jstate.opt_state[0]), bn_state, pcfg)
    want["state"] = state_dict_from_numpy(
        jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, jstate.bn_state), pcfg)

    assert int(jstate.step) == steps
    return _run_port(pcfg, params, bn_state, batch, steps), want


def _compare(got, want, *, metric_rtol, grad_atol, param_atol, stat_atol,
             noise_atol=None, mean_atol=None, var_rtol=0.0):
    """``noise_atol``, where given, is the tolerance of the updated
    parameters whose reference gradient of step 1 is below ``NOISE_GRAD``
    (zero in exact arithmetic), and ``mean_atol`` that of the running means,
    which carry those parameters; every other parameter is held to
    ``param_atol`` and the running variances to ``stat_atol``."""
    for g, w in zip(got["metrics"], want["metrics"]):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=metric_rtol,
                                       atol=0, err_msg=key)
    names = [k for k in want["state"] if not k.endswith("num_batches_tracked")]
    trainable = [k for k in names if "running_" not in k]
    assert sorted(got["grads"]) == sorted(trainable)
    for key in trainable:
        np.testing.assert_allclose(got["grads"][key].numpy(),
                                   want["grads"][key].numpy(), rtol=0,
                                   atol=grad_atol, err_msg="grad " + key)
    held_tight = 0
    for key in names:
        g, w = got["state"][key].numpy(), want["state"][key].numpy()
        if "running_mean" in key and mean_atol is not None:
            np.testing.assert_allclose(g, w, rtol=0, atol=mean_atol,
                                       err_msg=key)
        elif "running_" in key:
            np.testing.assert_allclose(g, w, rtol=var_rtol, atol=stat_atol,
                                       err_msg=key)
        else:
            noise = np.zeros(w.shape, bool)
            if noise_atol is not None:
                noise = np.abs(want["grads"][key].numpy()) < NOISE_GRAD
                np.testing.assert_allclose(g[noise], w[noise], rtol=0,
                                           atol=noise_atol, err_msg=key)
            np.testing.assert_allclose(g[~noise], w[~noise], rtol=0,
                                       atol=param_atol, err_msg=key)
            held_tight += int((~noise).sum())
    total = sum(want["state"][k].numel() for k in trainable)
    assert len(trainable) > 30 and held_tight > 0.97 * total


@pytest.mark.parametrize("loss_method",
                         ["gap_loss", "triplet_loss", "superglue"])
def test_three_train_steps_match_jax_xla_f64(loss_method):
    """Every Pallas kernel off, float64. Loss and grad_norm to 1e-9
    relative, gradients and running stats to 1e-9 absolute. Updated
    parameters to 1e-8: Adam divides by sqrt(v) + 1e-8, so where a gradient
    is zero in exact arithmetic (a conv bias ahead of BatchNorm, the key
    bias) its 1e-17 rounding noise still moves the update by ~lr * 1e-9."""
    got, want = _run_both(loss_method, "float64", 3)
    _compare(got, want, metric_rtol=1e-9, grad_atol=1e-9, param_atol=1e-8,
             stat_atol=1e-9)
    assert got["metrics"][2]["loss"] < got["metrics"][0]["loss"]


@pytest.mark.parametrize("loss_method",
                         ["gap_loss", "triplet_loss", "superglue"])
def test_three_train_steps_match_jax_pallas_kernel_pairs_f32(loss_method):
    """The JAX package as the port's training path is laid out (fused-MHA
    and Sinkhorn kernel pairs, interpret mode, exact top-k, no whole-layer
    train kernel), float32, two layers (a top-k self layer and a dense cross
    layer). Loss and grad_norm to 5e-5 relative and gradients to 2e-6
    absolute (f32 sums in other orders through the layers and five Sinkhorn
    iterations, forward and backward; the largest gradient entry is about
    0.3). Updated parameters to 1e-5 wherever the reference gradient of
    step 1 is at least ``NOISE_GRAD``: Adam's step is lr times a ratio of
    gradients, so a gradient right to 1e-7 relative moves it by far less.
    Where that gradient is zero in exact arithmetic (a conv bias ahead of
    BatchNorm, the key bias; under 3% of the entries) it is f32 noise of
    the order of Adam's eps on both sides, Adam's step, at most lr, may
    take either sign on either side, and those entries get 2.1 * lr per
    step. The running means carry those biases at momentum 0.1, twice a
    step (cloud 0, then cloud 1): a fifth of the biases' tolerance. The
    running variances do not see a bias: 1e-5 relative and absolute. The
    float64 test holds all of them tight."""
    steps = 3
    got, want = _run_both(loss_method, "float32", steps, over=dict(L=1),
                          port_flags=dict(train_layer=False),
                          pallas_interpret=True, pallas_exact_topk=True,
                          pallas_train_layer=False)
    _compare(got, want, metric_rtol=5e-5, grad_atol=2e-6, param_atol=1e-5,
             noise_atol=2.1 * LR * steps, mean_atol=0.2 * 2.1 * LR * steps,
             stat_atol=1e-5, var_rtol=1e-5)


@pytest.mark.parametrize("loss_method",
                         ["gap_loss", "triplet_loss", "superglue"])
def test_three_train_steps_match_jax_default_routing_f32(loss_method):
    """The JAX package at its default routing (whole-layer train kernels
    and the Sinkhorn pair, interpret mode, exact top-k) against the port's
    default ``train_layer=True``, which on the CPU takes the whole-layer
    kernels' plain twin: single-pass variance on both sides. float32, two
    layers, gradients of step 1 and the state after three steps, with the
    tolerances of the test above and for its reasons."""
    steps = 3
    got, want = _run_both(loss_method, "float32", steps, over=dict(L=1),
                          port_flags=dict(train_layer=True),
                          pallas_interpret=True, pallas_exact_topk=True,
                          pallas_train_layer=True)
    _compare(got, want, metric_rtol=5e-5, grad_atol=2e-6, param_atol=1e-5,
             noise_atol=2.1 * LR * steps, mean_atol=0.2 * 2.1 * LR * steps,
             stat_atol=1e-5, var_rtol=1e-5)


@pytest.mark.parametrize("loss_method",
                         ["gap_loss", "triplet_loss", "superglue"])
def test_port_train_routes_agree_f64(loss_method):
    """The port's whole-layer route (single-pass variance) against its
    ``train_layer=False`` route (two-pass) over three steps at float64, with
    the tolerances of the float64 test against the JAX package: the same
    step, and equal state dicts apart from rounding
    (``num_batches_tracked`` included)."""
    params, bn_state = _weights("float64")
    batch = _batch("float64")
    runs = []
    for flag in (True, False):
        cfg = port_train_defaults(**TINY, loss_method=loss_method,
                                  param_dtype="float64",
                                  compute_dtype="float64", train_layer=flag)
        runs.append(_run_port(cfg, params, bn_state, batch, 3))
    got, want = runs
    _compare(got, want, metric_rtol=1e-9, grad_atol=1e-9, param_atol=1e-8,
             stat_atol=1e-9)
    for key, value in want["state"].items():
        if key.endswith("num_batches_tracked"):
            assert int(got["state"][key]) == int(value) > 0, key


@pytest.mark.parametrize("flags", [dict(), dict(use_kernels=False),
                                   dict(train_layer=False)],
                         ids=["default", "no_kernels", "fused_mha"])
def test_loss_kernel_on_and_off_agree_f64(flags):
    """``loss_kernel=True`` (on the CPU: the margin kernels' plain twins,
    forward and backward formulas) against the plain ``gap_loss`` under
    autograd over three steps at float64: the same loss, gradients and state,
    on every route, ``use_kernels=False`` included (the loss route does not
    depend on it). Step 1's gradients to 1e-12; the state after three steps
    to the float64 tolerances of the tests above (Adam amplifies rounding
    where a gradient is zero in exact arithmetic)."""
    params, bn_state = _weights("float64")
    batch = _batch("float64")
    runs = []
    for flag in (True, False):
        cfg = port_train_defaults(**TINY, loss_method="gap_loss",
                                  param_dtype="float64",
                                  compute_dtype="float64", loss_kernel=flag,
                                  **flags)
        runs.append(_run_port(cfg, params, bn_state, batch, 3))
    got, want = runs
    _compare(got, want, metric_rtol=1e-10, grad_atol=1e-12, param_atol=1e-8,
             stat_atol=1e-9)


def test_loss_kernel_three_steps_match_jax_default_routing_f32():
    """The JAX package with ``pallas_loss`` is gated to accelerators, so its
    CPU train step never reaches the gap-loss kernel; this holds the port's
    ``loss_kernel=True`` step against the JAX package's default routing at
    float32 with the tolerances of the default-routing test."""
    steps = 3
    got, want = _run_both("gap_loss", "float32", steps, over=dict(L=1),
                          port_flags=dict(loss_kernel=True),
                          pallas_interpret=True, pallas_exact_topk=True,
                          pallas_train_layer=True)
    _compare(got, want, metric_rtol=5e-5, grad_atol=2e-6, param_atol=1e-5,
             noise_atol=2.1 * LR * steps, mean_atol=0.2 * 2.1 * LR * steps,
             stat_atol=1e-5, var_rtol=1e-5)


def test_save_resume_reproduces_the_next_step(tmp_path):
    cfg = port_train_defaults(**TINY)
    batch = _batch("float32")
    step = make_train_step()
    state = create_train_state(cfg, device="cpu", seed=3, learning_rate=LR)
    for _ in range(2):
        state, metrics = step(state, batch)
    path = str(tmp_path / "model_epoch_2.pth")
    save_train_checkpoint(path, state, epoch=2, loss=float(metrics["loss"]))
    ckpt = torch.load(path, weights_only=True)
    assert sorted(ckpt) == ["epoch", "loss", "lr_schedule", "net", "optimizer"]
    assert all(k.startswith("module.") for k in ckpt["net"])
    state, want = step(state, batch)

    resumed = create_train_state(cfg, device="cpu", seed=99, learning_rate=0.5)
    meta = load_train_checkpoint(path, resumed)
    assert meta["epoch"] == 2 and meta["lr_schedule"] == LR
    assert resumed.step == 2
    assert resumed.optimizer.param_groups[0]["lr"] == LR   # not the 0.5 above
    resumed, got = step(resumed, batch)
    assert float(got["loss"]) == float(want["loss"])
    assert float(got["grad_norm"]) == float(want["grad_norm"])
    for (k, a), b in zip(state.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), k

    # the reference's resume: weights only, a fresh Adam at the saved lr
    fresh = create_train_state(cfg, device="cpu", seed=99, learning_rate=0.5)
    load_train_checkpoint(path, fresh, fresh_optimizer=True)
    assert fresh.step == 0 and not fresh.optimizer.state
    assert fresh.optimizer.param_groups[0]["lr"] == LR
    fresh, first = step(fresh, batch)
    assert float(first["loss"]) == float(want["loss"])     # same weights
    assert not torch.equal(fresh.model.bin_score, state.model.bin_score)


def test_eval_step_uses_running_stats_and_restores_the_mode():
    cfg = port_train_defaults(**TINY)
    batch = _batch("float32")
    state = create_train_state(cfg, device="cpu", seed=4)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    state.model.train()
    out = make_eval_step(state.model)(batch)
    assert state.model.training
    assert out["loss"].shape == (4,) and not out["loss"].requires_grad
    assert out["matches0"].shape == (4, 48)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    with pytest.raises(ValueError, match="seed or a state_dict"):
        create_train_state(cfg, device="cpu")


def test_cuda_train_state_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_train_state(port_train_defaults(**TINY), device="cuda", seed=0)
