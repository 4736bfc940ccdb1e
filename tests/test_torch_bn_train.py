"""Port parity of train-mode BatchNorm and the MLP around it
(``mdgat_tpu_torch.ops.mlp``) against ``mdgat_tpu.ops.mlp.mlp_apply(train=
True)``: outputs, running statistics after one and after two sequential
applications (cloud 0, then cloud 1), masked and unmasked, and the
gradients through the batch statistics. float64, tolerance 1e-9.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mdgat_tpu.ops.mlp import mlp_apply, mlp_init, mlp_state_init

from mdgat_tpu_torch.core.checkpoint import _mlp as mlp_state_dict
from mdgat_tpu_torch.ops.mlp import BatchNorm, apply_mlp, mlp

CH = [12, 16, 20, 8]
TOL = dict(rtol=0, atol=1e-9)


def _trees(seed):
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, mlp_init(jax.random.PRNGKey(seed), CH,
                                               dtype=jnp.float64))
    state = jax.tree.map(np.asarray, mlp_state_init(CH, dtype=jnp.float64))
    for p, s in zip(params, state):
        if "bn" in p:
            c = p["bn"]["scale"].shape[0]
            p["bn"] = {"scale": rng.uniform(0.5, 1.5, c),
                       "bias": rng.normal(size=c) * 0.2}
            s.update(mean=rng.normal(size=c) * 0.3, var=rng.uniform(0.5, 1.5, c))
    return params, state


def _port_mlp(params, state):
    seq = mlp(CH, dtype=torch.float64)
    sd = {}
    mlp_state_dict(params, state, "m", sd)
    seq.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    return seq


def _inputs(seed, masked):
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=(3, 10, CH[0])), rng.normal(size=(3, 14, CH[0]))]
    if not masked:
        return xs, [None, None]
    return xs, [np.arange(10)[None, :] < np.array([[10], [7], [3]]),
                np.arange(14)[None, :] < np.array([[9], [14], [1]])]


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_train_mode_outputs_and_running_stats_two_applications(masked):
    params, state = _trees(31)
    seq = _port_mlp(params, state).train()
    xs, masks = _inputs(32, masked)
    st = state
    for x, m in zip(xs, masks):
        want, st = mlp_apply(params, st, jnp.asarray(x), True,
                             None if m is None else jnp.asarray(m))
        got = apply_mlp(seq, torch.from_numpy(x),
                        None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
        bns = [l for l in seq if isinstance(l, BatchNorm)]
        for bn, s in zip(bns, [s for s in st if s is not None]):
            np.testing.assert_allclose(bn.running_mean.numpy(),
                                       np.asarray(s["mean"]), **TOL)
            np.testing.assert_allclose(bn.running_var.numpy(),
                                       np.asarray(s["var"]), **TOL)
    assert all(int(bn.num_batches_tracked) == 2 for bn in bns)
    # the running stats moved away from where they started
    assert not np.allclose(bns[0].running_mean.numpy(), state[0]["mean"])


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_train_mode_gradients_flow_through_batch_statistics(masked):
    params, state = _trees(33)
    xs, masks = _inputs(34, masked)
    x, m = xs[0], masks[0]
    g = np.random.default_rng(35).normal(size=(3, 10, CH[-1]))
    jm = None if m is None else jnp.asarray(m)

    def loss(p, xx):
        return jnp.sum(mlp_apply(p, state, xx, True, jm)[0] * g)

    gp, gx = jax.grad(loss, (0, 1))(params, jnp.asarray(x))
    seq = _port_mlp(params, state).train()
    xt = torch.from_numpy(x).requires_grad_()
    (apply_mlp(seq, xt, None if m is None else torch.from_numpy(m))
     * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    for i, p in enumerate(gp):
        conv = seq[3 * i]
        np.testing.assert_allclose(conv.weight.grad[:, :, 0].t().numpy(),
                                   np.asarray(p["lin"]["w"]), **TOL)
        np.testing.assert_allclose(conv.bias.grad.numpy(),
                                   np.asarray(p["lin"]["b"]), **TOL)
        if "bn" in p:
            bn = seq[3 * i + 1]
            np.testing.assert_allclose(bn.weight.grad.numpy(),
                                       np.asarray(p["bn"]["scale"]), **TOL)
            np.testing.assert_allclose(bn.bias.grad.numpy(),
                                       np.asarray(p["bn"]["bias"]), **TOL)


def test_eval_mode_leaves_the_running_stats_alone_and_splits_the_first_conv():
    params, state = _trees(36)
    seq = _port_mlp(params, state).eval()
    x = np.random.default_rng(37).normal(size=(2, 9, CH[0]))
    want, st = mlp_apply(params, state, jnp.asarray(x), False)
    parts = (torch.from_numpy(x[..., :5].copy()), torch.from_numpy(x[..., 5:].copy()))
    with torch.no_grad():
        np.testing.assert_allclose(apply_mlp(seq, parts).numpy(),
                                   np.asarray(want), **TOL)
    bn = seq[1]
    np.testing.assert_array_equal(bn.running_mean.numpy(), state[0]["mean"])
    assert int(bn.num_batches_tracked) == 0


def test_single_valid_point_and_empty_mask_stay_finite():
    """cnt = max(sum(mask), 1) and n / max(n - 1, 1): one valid point gives
    zero variance, no valid point gives zero mean, neither a NaN."""
    params, state = _trees(38)
    x = np.random.default_rng(39).normal(size=(2, 6, CH[0]))
    for count in (1, 0):
        m = np.zeros((2, 6), bool)
        m[0, :count] = True
        want, st = mlp_apply(params, state, jnp.asarray(x), True, jnp.asarray(m))
        seq = _port_mlp(params, state).train()
        got = apply_mlp(seq, torch.from_numpy(x), torch.from_numpy(m))
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(seq[1].running_var.numpy(),
                                   np.asarray(st[0]["var"]), **TOL)
