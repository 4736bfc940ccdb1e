"""Port parity of the five descriptor modes and of staged training:
``MDGAT`` / ``SuperGlue`` of ``mdgat_tpu_torch`` against ``model.apply(...,
return_full_scores=True)`` of the JAX package at float64 on the CPU, from
the same weights (``state_dict_from_numpy``) on the same batch
(``tests/test_model.py``'s ``tiny_batch`` with padded slots and
``clouds_near_keypoints``): scores to 1e-8 relative, matches equal, loss to
1e-9 relative, eval and train mode; one ``make_train_step`` step of
``train_step`` 1, 2 and 3 against ``jax.grad`` and ``optax.adam`` (the
gradients to 1e-8 absolute with the zero-or-None pattern of
``tests/test_pointnet.py::test_staged_training``); and ``Matcher`` with the
FPFH variants against the JAX ``Matcher``, and refusing the pointnet
modes."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from mdgat_tpu.api import Matcher as JaxMatcher
from mdgat_tpu.core.config import test_defaults as jax_test_defaults
from mdgat_tpu.data.synthetic import make_synthetic_pair
from mdgat_tpu.models import build_model as jax_build_model
from mdgat_tpu.train import make_train_step as jax_make_train_step
from mdgat_tpu.train.loop import TrainState as JaxTrainState

from mdgat_tpu_torch import Matcher
from mdgat_tpu_torch.core.checkpoint import state_dict_from_numpy
from mdgat_tpu_torch.core.config import train_defaults
from mdgat_tpu_torch.models.factory import build_model
from mdgat_tpu_torch.train import create_train_state, make_train_step

from test_model import clouds_near_keypoints, tiny_batch, tiny_cfg

DESCRIPTORS = ["FPFH", "FPFH_gloabal", "FPFH_only", "pointnet", "pointnetmsg"]
FIELDS = ("L", "k", "descriptor_dim", "keypoint_encoder", "descriptor_encoder",
          "sinkhorn_iterations", "compute_dtype", "param_dtype", "descriptor",
          "net", "train_step", "loss_method")
LR = 1e-3


def _weights(cfg):
    """JAX-initialised trees as numpy, with random BN affines and running
    stats and a non-zero final bias in every stack, a non-default bin
    score."""
    params, state = jax_build_model(cfg).init(jax.random.PRNGKey(21))
    params = jax.tree.map(np.array, params)
    state = jax.tree.map(np.array, state)
    rng = np.random.default_rng(2100)

    def visit(p, s):
        if isinstance(p, list) and p and isinstance(p[0], dict) and "lin" in p[0]:
            for layer, st in zip(p, s):
                if "bn" in layer:
                    c = layer["bn"]["scale"].shape[0]
                    layer["bn"] = {"scale": rng.uniform(0.5, 1.5, c),
                                   "bias": rng.normal(size=c) * 0.2}
                    st.update(mean=rng.normal(size=c) * 0.3,
                              var=rng.uniform(0.5, 1.5, c))
            p[-1]["lin"]["b"] = rng.normal(size=p[-1]["lin"]["b"].shape) * 0.1
        elif isinstance(p, dict):
            for k in p:
                if k in s:
                    visit(p[k], s[k])
        elif isinstance(p, list):
            for a, b in zip(p, s):
                visit(a, b)

    for key in params:
        if key in state:
            visit(params[key], state[key])
    params["bin_score"] = np.asarray(0.6)
    return params, state


def _batch(cfg, seed=0):
    """``tiny_batch`` (2 pairs of 24 keypoints) with clouds around the
    keypoints and a padded tail in each cloud (masked, ground truth -1)."""
    batch = {k: np.array(v) for k, v in tiny_batch(cfg, b=2, n=24, m=24,
                                                   seed=seed).items()}
    rng = np.random.default_rng(seed + 1)
    c0, c1 = clouds_near_keypoints(batch["keypoints0"], batch["keypoints1"],
                                   rng)
    batch["cloud0"], batch["cloud1"] = np.asarray(c0), np.asarray(c1)
    mask0 = np.arange(24)[None] < np.array([[24], [19]])
    mask1 = np.arange(24)[None] < np.array([[21], [24]])
    gt0, gt1 = batch["gt_matches0"], batch["gt_matches1"]
    gt0[~mask0] = -1
    gt1[~mask1] = -1
    gt0[np.take_along_axis(~mask1, np.maximum(gt0, 0), 1) & (gt0 >= 0)] = -1
    gt1[np.take_along_axis(~mask0, np.maximum(gt1, 0), 1) & (gt1 >= 0)] = -1
    batch.update(mask0=mask0, mask1=mask1)
    return batch


def _setup(descriptor, net="mdgat", **over):
    cfg = tiny_cfg(descriptor=descriptor, net=net, L=1, k=(8, None),
                   **over)
    pcfg = train_defaults(**{f: getattr(cfg, f) for f in FIELDS})
    params, state = _weights(cfg)
    model = build_model(pcfg)
    model.load_state_dict(state_dict_from_numpy(params, state, pcfg),
                          strict=True)
    return cfg, pcfg, params, state, model


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("net", ["mdgat", "superglue"])
@pytest.mark.parametrize("descriptor", DESCRIPTORS)
def test_forward_equals_the_jax_model(descriptor, net, train):
    cfg, pcfg, params, state, model = _setup(descriptor, net)
    batch = _batch(cfg)
    want, new_state = jax_build_model(cfg).apply(
        params, state, {k: jnp.asarray(v) for k, v in batch.items()},
        train=train, return_full_scores=True)
    model.train(train)
    with torch.no_grad():
        got = model(_tensors(batch), return_full_scores=True)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]),
                               rtol=1e-8, atol=1e-12)
    for key in ("matches0", "matches1"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    np.testing.assert_allclose(got["loss"].numpy(), np.asarray(want["loss"]),
                               rtol=1e-9, atol=0)
    if train:       # every running statistic moved as the JAX ones did
        want_sd = state_dict_from_numpy(
            params, jax.tree.map(np.asarray, new_state), pcfg)
        got_sd = model.state_dict()
        stats = [k for k in want_sd if "running_" in k]
        for key in stats:
            np.testing.assert_allclose(got_sd[key].numpy(),
                                       want_sd[key].numpy(), rtol=1e-9,
                                       atol=1e-12, err_msg=key)


@pytest.mark.parametrize("train_step", [1, 2, 3])
def test_staged_step_equals_jax_grad_and_adam(train_step):
    """One ``make_train_step`` step from a fresh Adam against the JAX step's
    body (``mdgat_tpu/train/loop.py::make_train_step``: ``jax.grad`` of the
    mean loss, ``optax.adam``, ``apply_updates``) on the same batch.

    Gradients to 1e-8 absolute, with the pattern of
    ``tests/test_pointnet.py::test_staged_training``: ``train_step`` 1 gives
    the GNN and ``final_proj`` no gradient (None here, zero in JAX) and the
    encoder one; 2 the encoder none (detached) and the GNN one; 3 both.
    Then loss and grad_norm to 1e-9 relative, the updated parameters to 1e-8
    and the running stats to 1e-9 (``tests/test_torch_train_step.py``'s
    float64 tolerances); a parameter without a gradient stays where it was
    on both sides (JAX: zero gradient and zero moments, so a zero update).

    The JAX side runs eagerly: compiled by ``jax.jit`` on the CPU, its
    gradients of the first two ``sa1`` convs and BNs of the pointnet
    encoder disagree with central differences (one weight entry: 14.7361 by
    differences and by eager ``jax.grad``, 17.4494 under ``jax.jit``), while
    the eager gradients and the port's agree to 1e-14.

    ``pointnet`` (the multi-scale mode runs the same per-scale code three
    times; its train forward and BN updates are held above)."""
    cfg, pcfg, params, state, _ = _setup("pointnet", train_step=train_step)
    batch = _batch(cfg)
    jmodel = jax_build_model(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        out, new_bn = jmodel.apply(p, state, jb, train=True)
        return jnp.mean(out["loss"]), new_bn

    (jloss, new_bn), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        params)
    tx = optax.adam(LR)
    updates, _ = tx.update(jgrads, tx.init(params), params)
    want = state_dict_from_numpy(
        jax.tree.map(np.asarray, optax.apply_updates(params, updates)),
        jax.tree.map(np.asarray, new_bn), pcfg)
    jgrads = state_dict_from_numpy(jax.tree.map(np.asarray, jgrads), state,
                                   pcfg)

    pstate = create_train_state(
        pcfg, device="cpu", learning_rate=LR,
        state_dict=state_dict_from_numpy(params, state, pcfg))
    pstate, metrics = make_train_step()(pstate, _tensors(batch))
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss),
                               rtol=1e-9, atol=0)
    names = [name for name, _ in pstate.model.named_parameters()]
    np.testing.assert_allclose(
        float(metrics["grad_norm"]),
        float(np.sqrt(sum((jgrads[n].numpy() ** 2).sum() for n in names))),
        rtol=1e-9, atol=0)
    groups = {"penc": [], "gnn": [], "final_proj": []}
    for name, p in pstate.model.named_parameters():
        if p.grad is None:
            assert not jgrads[name].numpy().any(), name
        else:
            np.testing.assert_allclose(p.grad.numpy(), jgrads[name].numpy(),
                                       rtol=0, atol=1e-8, err_msg=name)
        for g in groups:
            if name.startswith(g):
                groups[g].append(p.grad is not None)
    flags = {g: (all(v), any(v)) for g, v in groups.items()}
    assert flags["gnn"] == flags["final_proj"]
    want_flags = {1: ((True, True), (False, False)),
                  2: ((False, False), (True, True)),
                  3: ((True, True), (True, True))}[train_step]
    assert (flags["penc"], flags["gnn"]) == want_flags

    got = pstate.model.state_dict()
    before = state_dict_from_numpy(params, state, pcfg)
    for key, w in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[key].numpy(), w.numpy(), rtol=0,
                                   atol=1e-9 if "running_" in key else 1e-8,
                                   err_msg=key)
    for name, p in pstate.model.named_parameters():
        if p.grad is None:
            assert torch.equal(got[name], before[name]), name


def test_adam_step_equals_the_jax_step_fpfh_gloabal():
    """``FPFH_gloabal``'s global max-pool under one ``make_train_step`` step
    against the compiled JAX step, with the float64 tolerances above."""
    cfg, pcfg, params, state, _ = _setup("FPFH_gloabal")
    batch = _batch(cfg, seed=3)
    tx = optax.adam(LR)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = JaxTrainState(jp, jax.tree.map(jnp.asarray, state), tx.init(jp),
                           jnp.zeros((), jnp.int32))
    jstep = jax_make_train_step(jax_build_model(cfg), tx, donate=False)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    want = state_dict_from_numpy(jax.tree.map(np.asarray, jstate.params),
                                 jax.tree.map(np.asarray, jstate.bn_state),
                                 pcfg)
    pstate = create_train_state(
        pcfg, device="cpu", learning_rate=LR,
        state_dict=state_dict_from_numpy(params, state, pcfg))
    pstate, pm = make_train_step()(pstate, _tensors(batch))
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(pm[key]), float(jm[key]), rtol=1e-9,
                                   atol=0, err_msg=key)
    got = pstate.model.state_dict()
    for key, w in want.items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_allclose(
                got[key].numpy(), w.numpy(), rtol=0,
                atol=1e-9 if "running_" in key else 1e-8, err_msg=key)


def _pairs(seed):
    rng = np.random.default_rng(seed)
    out = []
    for n0, n1 in [(40, 52), (31, 47)]:
        p = make_synthetic_pair(rng, n_points=max(n0, n1), overlap=0.8,
                                jitter=0.02, desc_noise=0.02)
        out.append(dict(kp0=p["kp0"][:n0], desc0=p["desc0"][:n0],
                        score0=p["score0"][:n0], kp1=p["kp1"][:n1],
                        desc1=p["desc1"][:n1], score1=p["score1"][:n1]))
    return out


@pytest.mark.parametrize("descriptor", ["FPFH_only", "FPFH_gloabal"])
def test_matcher_takes_the_fpfh_variants(descriptor):
    tiny = dict(L=1, k=(8, None), descriptor_dim=32, keypoint_encoder=(16, 32),
                descriptor_encoder=(16,), compute_dtype="float64",
                param_dtype="float64", descriptor=descriptor)
    params, state = _weights(jax_test_defaults(**tiny))
    ref = JaxMatcher(params=params, bn_state=state, **tiny)
    port = Matcher(params=params, bn_state=state, device="cpu", **tiny)
    pairs = _pairs(2200)
    for g, w in zip(port.match_batch(pairs), ref.match_batch(pairs)):
        for key in ("matches0", "matches1"):
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
        for key in ("matching_scores0", "matching_scores1"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("descriptor", ["pointnet", "pointnetmsg"])
def test_matcher_refuses_the_pointnet_modes(descriptor):
    with pytest.raises(ValueError, match="raw clouds"):
        Matcher(seed=0, device="cpu", descriptor=descriptor)


def test_bf16_casts_the_cloud_before_the_ball_query(monkeypatch):
    """At ``compute_dtype="bfloat16"`` the raw clouds reach the ball query
    (``pairwise_dist2``) in bfloat16, as ``mdgat_tpu/models/mdgat.py:129-130``
    casts them, and the eval forward gives finite scores."""
    from mdgat_tpu_torch.ops import pointnet as pp
    seen = []
    dist2 = pp.pairwise_dist2

    def spy(a, b):
        seen.append((a.dtype, b.dtype))
        return dist2(a, b)

    monkeypatch.setattr(pp, "pairwise_dist2", spy)
    cfg, pcfg, params, state, _ = _setup("pointnetmsg")
    model = build_model(pcfg.replace(compute_dtype="bfloat16",
                                     param_dtype="float32"))
    model.reset_parameters(0)
    batch = {k: (torch.from_numpy(v).float() if v.dtype == np.float64
                 else torch.from_numpy(v)) for k, v in _batch(cfg).items()}
    with torch.no_grad():
        out = model.eval()(batch, return_full_scores=True)
    assert seen and all(d == (torch.bfloat16, torch.bfloat16) for d in seen)
    assert len(seen) == 2 * 3              # two clouds, three radii
    assert torch.isfinite(out["scores"]).all()
