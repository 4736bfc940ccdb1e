"""Port parity of the whole-layer training path
(``mdgat_tpu_torch.ops.cuda.train_layer``): its plain twin, which is what
the CUDA kernels are held against on the card, against the JAX package's
``fused_train_layer_apply`` Pallas kernels in interpret mode with exact
top-k (float32) and against autodiff through its XLA train path (float64):
the output ``y = x + delta``, the updated BatchNorm running statistics, and
the gradients of x, source and all fourteen layer parameters.

Sizes follow the JAX package's own test of these kernels (d=32, 4 heads,
b=4, n=24, m=20; batch 8 for its multi-program grid).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mdgat_tpu.models.gnn import (attentional_propagation_apply,
                                  attentional_propagation_init)
from mdgat_tpu.ops.pallas.attention import (_tl_fwd_calls,
                                            fused_train_layer as jax_layer,
                                            fused_train_layer_apply as jax_apply)

from mdgat_tpu_torch.core.checkpoint import propagation_state_dict
from mdgat_tpu_torch.models.gnn import AttentionalPropagation
from mdgat_tpu_torch.ops.cuda import _build
from mdgat_tpu_torch.ops.cuda import mha
from mdgat_tpu_torch.ops.cuda import train_layer as T
from mdgat_tpu_torch.ops.mlp import BN_EPS

HEADS = 4
# the JAX package's own tolerances for these kernels against its XLA path
# (tests/test_pallas.py): f32 internals on both sides, other orders of sums
STAT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=3e-4, atol=3e-5)


def _trees(seed, d, np_dtype):
    """A layer's JAX trees as numpy, with a random BN affine, random running
    statistics and a non-zero last bias."""
    params, state = attentional_propagation_init(
        jax.random.PRNGKey(seed), d, HEADS, dtype=jnp.dtype(np_dtype))
    params = jax.tree.map(lambda a: np.array(a), params)
    state = jax.tree.map(lambda a: np.array(a), state)
    rng = np.random.default_rng(seed)
    c = 2 * d
    params["mlp"][0]["bn"] = {
        "scale": rng.uniform(0.5, 1.5, c).astype(np_dtype),
        "bias": (rng.normal(size=c) * 0.2).astype(np_dtype)}
    state["mlp"][0] = {"mean": (rng.normal(size=c) * 0.3).astype(np_dtype),
                       "var": rng.uniform(0.5, 1.5, c).astype(np_dtype)}
    params["mlp"][1]["lin"]["b"] = (rng.normal(size=d) * 0.1).astype(np_dtype)
    return params, state


def _port_layer(params, state, dtype):
    d = params["attn"]["q"]["w"].shape[0]
    layer = AttentionalPropagation(d, HEADS, dtype=dtype)
    layer.load_state_dict(propagation_state_dict(params, state), strict=True)
    return layer.train()


def _weights(layer):
    """The layer's fourteen kernel operands as plain tensors."""
    return [w.detach() for w in T.train_layer_weights(layer)]


def _inputs(seed, b, n, m, d, masked, selfattn, np_dtype):
    """x, source, the cotangent of y, and row / key masks with unequal
    counts. Padded rows keep a non-zero cotangent."""
    rng = np.random.default_rng(seed)
    if selfattn:
        m = n
    x = rng.normal(size=(b, n, d)).astype(np_dtype)
    src = x if selfattn else rng.normal(size=(b, m, d)).astype(np_dtype)
    g = rng.normal(size=(b, n, d)).astype(np_dtype)
    vm = km = None
    if masked:
        vm = np.arange(n)[None, :] < rng.integers(n // 2, n + 1, b)[:, None]
        km = vm if selfattn else (np.arange(m)[None, :]
                                  < rng.integers(m // 2, m + 1, b)[:, None])
    return x, src, g, vm, km


def _tt(a):
    return None if a is None else torch.from_numpy(a)


def _jj(a):
    return None if a is None else jnp.asarray(a)


def _port_run(layer, x, src, g, vm, km, topk, selfattn):
    """(y, {name: grad}) of sum(fused_train_layer_apply(...) * g); the
    layer's running statistics move in place."""
    xt = _tt(x).requires_grad_()
    st = xt if selfattn else _tt(src).requires_grad_()
    y = T.fused_train_layer_apply(layer, xt, st, topk, _tt(km), _tt(vm))
    (y * _tt(g)).sum().backward()
    grads = {"x": xt.grad.numpy()}
    if not selfattn:
        grads["src"] = st.grad.numpy()
    grads.update({k: p.grad.numpy() for k, p in layer.named_parameters()})
    return y.detach().numpy(), grads


def _jax_run(fn, params, state, x, src, g, selfattn):
    """The same through a JAX layer function ``fn(p, x, src) -> (y, new
    state)``, gradients named like the port's parameters."""
    jp = jax.tree.map(jnp.asarray, params)

    def loss(p, xx, ss):
        y, nst = fn(p, xx, xx if selfattn else ss)
        return jnp.sum(y * jnp.asarray(g)), (y, nst)

    (_, (y, nst)), (gp, gx, gs) = jax.value_and_grad(
        loss, (0, 1, 2), has_aux=True)(jp, jnp.asarray(x), jnp.asarray(src))
    grads = {"x": np.asarray(gx)}
    if not selfattn:
        grads["src"] = np.asarray(gs)
    named = propagation_state_dict(jax.tree.map(np.asarray, gp), state)
    grads.update({k: v.numpy() for k, v in named.items()
                  if "running_" not in k and "num_batches" not in k})
    return np.asarray(y), jax.tree.map(np.asarray, nst), grads


def _compare(layer, got_y, got, want_y, want_state, want, y_tol, stat_tol,
             grad_tol):
    np.testing.assert_allclose(got_y, want_y, **y_tol)
    bn = layer.mlp[1]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               want_state["mlp"][0]["mean"], **stat_tol)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               want_state["mlp"][0]["var"], **stat_tol)
    assert int(bn.num_batches_tracked) == 1
    assert sorted(got) == sorted(want) and len(got) >= 15
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key,
                                   **grad_tol)


CASES = [pytest.param(topk, masked, selfattn,
                      id=f"{'topk' if topk else 'dense'}-"
                         f"{'masked' if masked else 'unmasked'}-"
                         f"{'self' if selfattn else 'cross'}")
         for topk in (None, 6) for masked in (False, True)
         for selfattn in (False, True)]


@pytest.mark.parametrize("topk,masked,selfattn", CASES)
def test_train_layer_twin_matches_pallas_kernels_f32(topk, masked, selfattn):
    """float32 against the Pallas kernels (interpret mode, exact top-k): y
    to 2e-5, the running statistics to rtol 1e-5 / atol 1e-6, every gradient
    to rtol 3e-4 / atol 3e-5."""
    d, b, n, m = 32, 4, 24, 20
    params, state = _trees(3, d, np.float32)
    x, src, g, vm, km = _inputs(7 + (topk or 0) + masked, b, n, m, d, masked,
                                selfattn, np.float32)
    js = jax.tree.map(jnp.asarray, state)

    def fused(p, xx, ss):
        return jax_apply(p, js, xx, ss, topk, HEADS, valid_mask=_jj(vm),
                         kv_mask=_jj(km), exact=True, interpret=True)

    want_y, want_state, want = _jax_run(fused, params, state, x, src, g,
                                        selfattn)
    layer = _port_layer(params, state, torch.float32)
    got_y, got = _port_run(layer, x, src, g, vm, km, topk, selfattn)
    _compare(layer, got_y, got, want_y, want_state, want,
             dict(rtol=2e-5, atol=2e-5), STAT_TOL, GRAD_TOL)


@pytest.mark.parametrize("topk,masked,selfattn", CASES)
def test_train_layer_twin_matches_xla_train_path_f64(topk, masked, selfattn):
    """float64 against autodiff through the XLA path (two-pass variance),
    1e-9: there the single-pass variance agrees, so the fused route and the
    plain route compute the same layer."""
    d, b, n, m = 32, 4, 24, 20
    params, state = _trees(4, d, np.float64)
    x, src, g, vm, km = _inputs(17 + (topk or 0) + masked, b, n, m, d, masked,
                                selfattn, np.float64)
    js = jax.tree.map(jnp.asarray, state)

    def xla(p, xx, ss):
        delta, nst = attentional_propagation_apply(
            p, js, xx, ss, topk, HEADS, train=True, valid_mask=_jj(vm),
            kv_mask=_jj(km), use_pallas=False)
        return xx + delta, nst

    want_y, want_state, want = _jax_run(xla, params, state, x, src, g, selfattn)
    layer = _port_layer(params, state, torch.float64)
    got_y, got = _port_run(layer, x, src, g, vm, km, topk, selfattn)
    tol = dict(rtol=0, atol=1e-9)
    _compare(layer, got_y, got, want_y, want_state, want, tol, tol, tol)


def test_train_layer_twin_batch_8_matches_pallas_multi_program_grid():
    """Batch 8 runs the Pallas kernels over a grid of several programs, which
    accumulate the statistics and the weight gradients from one program to
    the next; the twin sums them in one pass."""
    d, b, n = 16, 8, 12
    params, state = _trees(5, d, np.float32)
    x, src, g, vm, km = _inputs(11, b, n, n, d, True, False, np.float32)
    js = jax.tree.map(jnp.asarray, state)

    def fused(p, xx, ss):
        return jax_apply(p, js, xx, ss, 6, HEADS, valid_mask=_jj(vm),
                         kv_mask=_jj(km), exact=True, interpret=True)

    want_y, want_state, want = _jax_run(fused, params, state, x, src, g, False)
    layer = _port_layer(params, state, torch.float32)
    got_y, got = _port_run(layer, x, src, g, vm, km, 6, False)
    _compare(layer, got_y, got, want_y, want_state, want,
             dict(rtol=2e-5, atol=2e-5), STAT_TOL, GRAD_TOL)


def test_forward_residuals_match_pallas_and_numpy():
    """h1, thr, lse, ssum, ssq and the batch mean / variance of the twin's
    forward against ``_tl_fwd_calls`` (interpret mode, 2e-5) and against the
    sums taken with numpy from the twin's own h1 (masked rows left out)."""
    d, b, n, m, topk = 32, 4, 24, 20, 6
    params, state = _trees(6, d, np.float32)
    x, src, _, vm, km = _inputs(21, b, n, m, d, True, False, np.float32)
    jp = jax.tree.map(jnp.asarray, params)
    y_j, mean_j, var_j, cnt_j, thr_j, lse_j, h1_j = _tl_fwd_calls(
        jp, jnp.asarray(x), jnp.asarray(src), _jj(km), _jj(vm), topk, HEADS,
        True, True)
    layer = _port_layer(params, state, torch.float32)
    w = _weights(layer)
    y, mean, var, h1, thr, lse, ssum, ssq = T.fused_train_layer_forward(
        _tt(x), _tt(src), _tt(km), _tt(vm), topk, HEADS, *w)
    tol = dict(rtol=2e-5, atol=2e-5)
    for got, want in ((y, y_j), (mean, mean_j), (var, var_j), (h1, h1_j),
                      (thr, thr_j), (lse, lse_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    assert float(cnt_j) == vm.sum()
    rows = h1.numpy().astype(np.float64)[vm]
    np.testing.assert_allclose(ssum.numpy(), rows.sum(0), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ssq.numpy(), (rows ** 2).sum(0), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(var.numpy(), rows.var(0), rtol=1e-4, atol=1e-6)


def test_h1_and_dw2_twins_match_pallas_fwd1_and_bwd1():
    """The twins of ``tl_h1_kernel`` and ``tl_dw2_kernel`` alone, float32,
    ragged row and key masks: ``h1_stats_reference`` on the twin's message
    against ``_tl_fwd_calls``' h1 and batch mean / variance (interpret mode,
    2e-5), and ``dw2_db2_reference`` on that forward's h1 and statistics
    against dw2 / db2 of the Pallas backward (``_tl_bwd1_kernel`` through
    the custom VJP, interpret mode; rtol 3e-4 / atol 3e-5, the gradients'
    tolerance: sums of 96 rows in other orders)."""
    d, b, n, m, topk = 32, 4, 24, 20, 6
    params, state = _trees(9, d, np.float32)
    x, src, g, vm, km = _inputs(41, b, n, m, d, True, False, np.float32)
    jp = jax.tree.map(jnp.asarray, params)
    args = (jnp.asarray(x), jnp.asarray(src), _jj(km), _jj(vm))
    _, mean_j, var_j, _, _, _, h1_j = _tl_fwd_calls(jp, *args, topk, HEADS,
                                                    True, True)
    w = _weights(_port_layer(params, state, torch.float32))
    msg = mha.fused_mha_reference(_tt(x), _tt(src), _tt(km), topk, HEADS,
                                  *w[:8])
    h1, sums = T.h1_stats_reference(_tt(x), msg, w[8], w[9], _tt(vm))
    tol = dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(h1.numpy().reshape(b, n, 2 * d),
                               np.asarray(h1_j), **tol)
    mean = sums[0] / vm.sum()
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_j), **tol)
    np.testing.assert_allclose((sums[1] / vm.sum() - mean * mean).numpy(),
                               np.asarray(var_j), **tol)

    _, vjp = jax.vjp(
        lambda p: jax_layer(topk, HEADS, True, True, None, p, *args)[0], jp)
    (dlp,) = vjp(jnp.asarray(g))
    vec4 = torch.stack([_tt(np.array(mean_j)),
                        torch.rsqrt(_tt(np.array(var_j)) + BN_EPS), w[12], w[13]])
    dw2, db2 = T.dw2_db2_reference(_tt(g), _tt(np.array(h1_j)), vec4)
    np.testing.assert_allclose(dw2.numpy(), np.asarray(dlp["mlp"][1]["lin"]["w"]),
                               **GRAD_TOL)
    np.testing.assert_allclose(db2.numpy(), np.asarray(dlp["mlp"][1]["lin"]["b"]),
                               **GRAD_TOL)


def test_fwd2_twin_matches_pallas_fwd2():
    """The twin of ``tl_fwd2_kernel`` alone, float32, ragged row and key
    masks: ``bn_relu_conv2_reference`` on ``_tl_fwd_calls``' own h1, with a
    and c built from its batch mean and variance as ``_tl_fwd_calls``
    builds them, against its y (the Pallas ``_tl_fwd2_kernel``, interpret
    mode; 2e-5); ``bn_relu_conv2`` on the same CPU tensors returns the
    twin's values and launches nothing."""
    d, b, n, m, topk = 32, 4, 24, 20, 6
    params, state = _trees(11, d, np.float32)
    x, src, _, vm, km = _inputs(43, b, n, m, d, True, False, np.float32)
    jp = jax.tree.map(jnp.asarray, params)
    y_j, mean_j, var_j, _, _, _, h1_j = _tl_fwd_calls(
        jp, jnp.asarray(x), jnp.asarray(src), _jj(km), _jj(vm), topk, HEADS,
        True, True)
    w = _weights(_port_layer(params, state, torch.float32))
    inv = torch.rsqrt(_tt(np.array(var_j)) + BN_EPS)
    a = w[12] * inv
    c = w[13] - _tt(np.array(mean_j)) * w[12] * inv
    h1 = _tt(np.array(h1_j)).reshape(b * n, 2 * d)
    y = T.bn_relu_conv2_reference(_tt(x), h1, a, c, w[10], w[11])
    assert y.shape == (b, n, d) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=2e-5, atol=2e-5)
    before = T.bn_relu_conv2.launches
    assert torch.equal(T.bn_relu_conv2(_tt(x), h1, a, c, w[10], w[11]), y)
    assert T.bn_relu_conv2.launches == before


def test_bn_backward_sums_run_over_padded_rows_too():
    """``Sg``, ``Sgh``, ``dw2``, ``db2``, ``dscale``, ``dbias`` against numpy
    sums over ALL rows, with a cotangent that is non-zero on padded rows:
    sums over the valid rows alone differ, and the layer's BN gradients are
    the all-row ones."""
    d, b, n, m = 32, 4, 24, 20
    params, state = _trees(8, d, np.float64)
    x, src, g, vm, km = _inputs(23, b, n, m, d, True, False, np.float64)
    layer = _port_layer(params, state, torch.float64)
    w = _weights(layer)
    with torch.no_grad():
        _, mean, var, h1, *_ = T.fused_train_layer_forward(
            _tt(x), _tt(src), _tt(km), _tt(vm), None, HEADS, *w)
        got = T.bn_backward_sums_reference(_tt(g), h1, w[10], mean, var,
                                           w[12], w[13])
    scale, bias, w2 = w[12].numpy(), w[13].numpy(), w[10].numpy()
    hhat = (h1.numpy() - mean.numpy()) / np.sqrt(var.numpy() + BN_EPS)
    bn = hhat * scale + bias
    dbn = (g @ w2.T) * (bn > 0)

    def sums(rows):
        big_g = (dbn * scale)[rows]
        return (big_g.sum(0), (big_g * hhat[rows]).sum(0),
                np.maximum(bn, 0)[rows].T @ g[rows], g[rows].sum(0),
                (dbn * hhat)[rows].sum(0), dbn[rows].sum(0))

    every = np.ones_like(vm)
    for a, want in zip(got, sums(every)):
        np.testing.assert_allclose(a.numpy(), want, rtol=0, atol=1e-9)
    assert np.abs(sums(vm)[4] - sums(every)[4]).max() > 1e-2
    _, grads = _port_run(layer, x, src, g, vm, km, None, False)
    np.testing.assert_allclose(grads["mlp.1.weight"], sums(every)[4], rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(grads["mlp.1.bias"], sums(every)[5], rtol=0,
                               atol=1e-9)


def test_ties_at_the_kth_score_are_all_kept():
    """Two identical keys tie at the k-th score of every row: both are
    kept, as the Pallas kernels keep them, and no NaN appears."""
    d, b, n, m, topk = 32, 2, 12, 10, 3
    params, state = _trees(9, d, np.float32)
    x, src, g, _, _ = _inputs(25, b, n, m, d, False, False, np.float32)
    src[:, 1] = src[:, 0]
    src[:, 3] = src[:, 2]
    src[:, 5] = src[:, 4]
    js = jax.tree.map(jnp.asarray, state)

    def fused(p, xx, ss):
        return jax_apply(p, js, xx, ss, topk, HEADS, exact=True, interpret=True)

    want_y, want_state, want = _jax_run(fused, params, state, x, src, g, False)
    layer = _port_layer(params, state, torch.float32)
    got_y, got = _port_run(layer, x, src, g, None, None, topk, False)
    _compare(layer, got_y, got, want_y, want_state, want,
             dict(rtol=2e-5, atol=2e-5), STAT_TOL, GRAD_TOL)
    w = _weights(layer)
    with torch.no_grad():
        thr = T.fused_train_layer_forward(_tt(x), _tt(src), None, None, topk,
                                          HEADS, *w)[4]
        q = (_tt(x) @ w[0] + w[1]).reshape(b, n, HEADS, -1).transpose(1, 2)
        k = (_tt(src) @ w[2] + w[3]).reshape(b, m, HEADS, -1).transpose(1, 2)
        kept = ((q @ k.transpose(-1, -2)) >= thr).sum(-1)
    assert (kept >= topk).all() and (kept > topk).any()


def test_cloud_without_keys_gives_the_merge_bias_and_no_nan():
    """A pair whose source has no valid key: its attention rows are zeros,
    its message is the merge bias, and nothing is NaN, forward or
    backward; against the Pallas kernels."""
    d, b, n, m, topk = 32, 3, 12, 10, 4
    params, state = _trees(10, d, np.float32)
    x, src, g, vm, km = _inputs(27, b, n, m, d, True, False, np.float32)
    km[-1] = False
    js = jax.tree.map(jnp.asarray, state)

    def fused(p, xx, ss):
        return jax_apply(p, js, xx, ss, topk, HEADS, valid_mask=_jj(vm),
                         kv_mask=_jj(km), exact=True, interpret=True)

    want_y, want_state, want = _jax_run(fused, params, state, x, src, g, False)
    layer = _port_layer(params, state, torch.float32)
    got_y, got = _port_run(layer, x, src, g, vm, km, topk, False)
    assert np.isfinite(got_y).all()
    assert all(np.isfinite(v).all() for v in got.values())
    assert not got["src"][-1].any()
    _compare(layer, got_y, got, want_y, want_state, want,
             dict(rtol=2e-5, atol=2e-5), STAT_TOL, GRAD_TOL)


def test_two_applications_move_the_running_stats_twice():
    """Cloud 0, then cloud 1, through one layer: the statistics after both
    equal the JAX package's, threaded through its two applications."""
    d, b, n, m = 32, 4, 24, 20
    params, state = _trees(12, d, np.float32)
    x0, x1, _, vm0, vm1 = _inputs(29, b, n, m, d, True, False, np.float32)
    jp = jax.tree.map(jnp.asarray, params)
    st = jax.tree.map(jnp.asarray, state)
    layer = _port_layer(params, state, torch.float32)
    for x, s, vm, km in ((x0, x1, vm0, vm1), (x1, x0, vm1, vm0)):
        want, st = jax_apply(jp, st, jnp.asarray(x), jnp.asarray(s), 6, HEADS,
                             valid_mask=_jj(vm), kv_mask=_jj(km), exact=True,
                             interpret=True)
        with torch.no_grad():
            got = T.fused_train_layer_apply(layer, _tt(x), _tt(s), 6, _tt(km),
                                            _tt(vm))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)
    bn = layer.mlp[1]
    assert int(bn.num_batches_tracked) == 2
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(st["mlp"][0]["mean"]), **STAT_TOL)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(st["mlp"][0]["var"]), **STAT_TOL)


def test_cpu_tensors_never_reach_the_kernel_library(monkeypatch):
    """On a CPU tensor the entry takes the twin and never builds or loads
    the kernels; the launch wrappers take their plain twins (the h1, fwd2,
    dh2 and dw2 wrappers) and the forward's launch helper refuses a CPU
    tensor; the launch counts stay where they were."""
    def no_library():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(_build, "library", no_library)
    monkeypatch.setattr(T, "library", no_library)
    d, b, n, m = 32, 2, 12, 10
    params, state = _trees(13, d, np.float32)
    x, src, g, vm, km = _inputs(31, b, n, m, d, True, False, np.float32)
    layer = _port_layer(params, state, torch.float32)
    counters = lambda: (T.fused_train_layer.forward_launches,
                        T.fused_train_layer.backward_launches,
                        T.h1_stats.launches, T.bn_relu_conv2.launches,
                        T.bn_backward_sums.launches, T.dw2_db2.launches,
                        T.dh1_kernel.launches)
    before = counters()
    got_y, got = _port_run(layer, x, src, g, vm, km, 4, False)
    assert np.isfinite(got_y).all() and len(got) == 16
    w = _weights(layer)
    xt = _tt(x)
    h1 = torch.zeros(b * n, 2 * d)
    vec4 = torch.zeros(4, 2 * d)
    vec6 = torch.zeros(6, 2 * d)
    msg = torch.zeros(b * n, d)
    rowmask = torch.from_numpy(vm.reshape(-1).astype(np.uint8))
    assert all(torch.equal(a, c) for a, c in zip(
        T.h1_stats(xt, msg, w[8], w[9], rowmask),
        T.h1_stats_reference(xt, msg, w[8], w[9], rowmask)))
    assert torch.equal(T.bn_backward_sums(xt, h1, w[10], vec4),
                       T.bn_backward_sums_plain(xt, h1, w[10], vec4))
    assert all(torch.equal(a, c) for a, c in zip(
        T.dw2_db2(xt, h1, vec4), T.dw2_db2_reference(xt, h1, vec4)))
    assert torch.equal(T.dh1_kernel(xt, h1, w[10], vec6, None),
                       T.dh1_reference(xt, h1, w[10], vec6, None))
    assert torch.equal(T.bn_relu_conv2(xt, h1, w[12], w[13], w[10], w[11]),
                       T.bn_relu_conv2_reference(xt, h1, w[12], w[13], w[10],
                                                 w[11]))
    assert before == counters()
    with pytest.raises(ValueError, match="CUDA"):
        T._tl_forward(xt, xt, None, None, 4, HEADS, *w)
