"""Port parity: one eval attentional-propagation layer. The port's plain
twin of the layer kernel (``ops/cuda/layer.py``) and its unfused plain
layer are held against the JAX package's whole-layer Pallas kernel
(``fused_layer_apply``, exact selection, interpret mode) and its unfused
XLA layer, on the same numpy weights."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mdgat_tpu.models.gnn import (attentional_propagation_apply,
                                  attentional_propagation_init)
from mdgat_tpu.ops.pallas.attention import fused_layer_apply

from mdgat_tpu_torch.core.checkpoint import propagation_state_dict
from mdgat_tpu_torch.models.gnn import AttentionalPropagation
from mdgat_tpu_torch.ops.cuda import layer as layer_kernel

D, H = 32, 4


def _layer(seed, np_dtype):
    """JAX layer trees as numpy (random BN stats and affine so the fold is
    exercised) and the port layer loaded from them."""
    jdt = jnp.float64 if np_dtype == np.float64 else jnp.float32
    params, state = attentional_propagation_init(
        jax.random.PRNGKey(seed), D, H, dtype=jdt)
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed)
    params["mlp"][0]["bn"] = {
        "scale": rng.uniform(0.5, 1.5, 2 * D).astype(np_dtype),
        "bias": (rng.normal(size=2 * D) * 0.2).astype(np_dtype)}
    params["mlp"][1]["lin"]["b"] = (rng.normal(size=D) * 0.1).astype(np_dtype)
    state = {"mlp": [{"mean": (rng.normal(size=2 * D) * 0.3).astype(np_dtype),
                      "var": rng.uniform(0.5, 1.5, 2 * D).astype(np_dtype)},
                     None]}
    tdt = torch.float64 if np_dtype == np.float64 else torch.float32
    port = AttentionalPropagation(D, H, dtype=tdt)
    port.load_state_dict(propagation_state_dict(params, state), strict=True)
    return params, state, port.eval()


def _acts(seed, n, m, np_dtype, counts):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(len(counts), n, D)).astype(np_dtype)
    src = rng.normal(size=(len(counts), m, D)).astype(np_dtype)
    mask = np.arange(m)[None, :] < np.asarray(counts)[:, None]
    return x, src, mask


CASES = [(None, False), (8, False), (8, True), (None, True)]


@pytest.mark.parametrize("topk,masked", CASES)
def test_layer_twin_and_plain_layer_match_xla_f64(topk, masked):
    params, state, port = _layer(11, np.float64)
    x, src, mask = _acts(12, 37, 45, np.float64, (45, 31, 20))
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    delta, _ = attentional_propagation_apply(
        params, state, jnp.asarray(x), jnp.asarray(src), topk, H,
        train=False, kv_mask=jm)
    ref = x + np.asarray(delta)
    tx, ts = torch.from_numpy(x), torch.from_numpy(src)
    w = layer_kernel.prepare_layer_weights(port, torch.float64)
    got = layer_kernel.fused_layer(tx, ts, tm, topk, w)
    assert got.dtype == torch.float64 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-9)
    with torch.no_grad():
        plain = tx + port(tx, ts, topk, tm)
    np.testing.assert_allclose(plain.numpy(), ref, rtol=0, atol=1e-9)


@pytest.mark.parametrize("topk,masked", CASES[1:3])
def test_layer_twin_matches_fused_pallas_layer_f32(topk, masked):
    """f32 both sides; the query count (24) is not a multiple of the
    TPU kernel's blocking, the port takes any N."""
    params, state, port = _layer(13, np.float32)
    x, src, mask = _acts(14, 24, 40, np.float32, (40, 33))
    jm = jnp.asarray(mask) if masked else None
    ref = fused_layer_apply(params, state, jnp.asarray(x), jnp.asarray(src),
                            topk, H, kv_mask=jm, exact=True, interpret=True)
    w = layer_kernel.prepare_layer_weights(port)
    got = layer_kernel.fused_layer(torch.from_numpy(x), torch.from_numpy(src),
                                   torch.from_numpy(mask) if masked else None,
                                   topk, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-5)


def test_layer_twin_bf16_returns_input_dtype():
    _, _, port = _layer(15, np.float32)
    x, src, mask = _acts(16, 20, 28, np.float32, (28, 19))
    w = layer_kernel.prepare_layer_weights(port)
    xb, sb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, src))
    tm = torch.from_numpy(mask)
    got = layer_kernel.fused_layer(xb, sb, tm, 8, w)
    ref = layer_kernel.fused_layer(xb.float(), sb.float(), tm, 8, w)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(), rtol=0,
                               atol=3e-2)


def test_prepared_weights_cached_until_a_weight_changes():
    _, _, port = _layer(17, np.float32)
    w1 = port.kernel_weights()
    assert port.kernel_weights() is w1
    with torch.no_grad():
        port.mlp[1].running_var.mul_(2.0)
    w2 = port.kernel_weights()
    assert w2 is not w1 and not torch.equal(w2.w1, w1.w1)


def test_gemm_kernel_refuses_cpu_tensors():
    a = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        layer_kernel.gemm(a, torch.zeros(8, 8), torch.zeros(8))
