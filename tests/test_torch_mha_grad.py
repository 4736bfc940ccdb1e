"""Port parity of the fused multi-head attention used in training
(``mdgat_tpu_torch.ops.cuda.mha``): its plain twin, which is what the CUDA
kernels are held against on the card, against the JAX package's
``fused_mha`` Pallas kernel pair in interpret mode (float32) and against
autodiff through its XLA path (float64): the output, the residuals ``thr``
and ``lse``, and all ten gradients (x, source, four weights, four biases).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mdgat_tpu.ops.attention import multi_head_attention as jax_mha
from mdgat_tpu.ops.pallas.attention import _mha_fwd_call, fused_mha as jax_fused_mha

from mdgat_tpu_torch.models.gnn import MultiHeadedAttention
from mdgat_tpu_torch.ops.attention import multi_head_attention
from mdgat_tpu_torch.ops.cuda.mha import (blocked_weights, fused_mha,
                                          fused_mha_forward)

NAMES = ("q", "k", "v", "merge")


def _case(seed, b, n, m, d, masked, selfattn, np_dtype, dead_row=False):
    rng = np.random.default_rng(seed)
    if selfattn:
        m = n
    params = {nm: {"w": (rng.uniform(-1, 1, (d, d)) / np.sqrt(d)).astype(np_dtype),
                   "b": (rng.uniform(-1, 1, d) / np.sqrt(d)).astype(np_dtype)}
              for nm in NAMES}
    x = rng.normal(size=(b, n, d)).astype(np_dtype)
    src = x if selfattn else rng.normal(size=(b, m, d)).astype(np_dtype)
    g = rng.normal(size=(b, n, d)).astype(np_dtype)
    mask = None
    if masked:
        mask = np.ones((b, m), bool)
        mask[0, m - 3:] = False
        if dead_row:
            mask[-1] = False         # a cloud without keypoints
    return params, x, src, g, mask


def _port_attn(params, dtype):
    d = params["q"]["w"].shape[0]
    attn = MultiHeadedAttention(d, dtype=dtype)
    convs = list(attn.proj) + [attn.merge]
    with torch.no_grad():
        for conv, nm in zip(convs, NAMES):
            conv.weight.copy_(torch.from_numpy(params[nm]["w"].T[:, :, None].copy()))
            conv.bias.copy_(torch.from_numpy(params[nm]["b"]))
    return attn, convs


def _port_grads(attn, convs, x, src, g, mask, topk, heads, selfattn, fn):
    """(out, {name: grad}) of sum(fn(...) * g) in the JAX layout: dense
    weights [in, out]."""
    xt = torch.from_numpy(x).requires_grad_()
    st = xt if selfattn else torch.from_numpy(src).requires_grad_()
    mt = None if mask is None else torch.from_numpy(mask)
    out = fn(attn, xt, st, mt, topk, heads)
    (out * torch.from_numpy(g)).sum().backward()
    grads = {"x": xt.grad.numpy()}
    if not selfattn:
        grads["src"] = st.grad.numpy()
    for conv, nm in zip(convs, NAMES):
        grads[nm + ".w"] = conv.weight.grad[:, :, 0].t().numpy()
        grads[nm + ".b"] = conv.bias.grad.numpy()
    return out.detach().numpy(), grads


def _fused(attn, x, src, mask, topk, heads):
    return fused_mha(x, src, mask, topk, heads, *blocked_weights(attn, heads))


def _plain(attn, x, src, mask, topk, heads):
    return multi_head_attention(attn, x, src, topk, heads, kv_mask=mask)


def _jax_grads(fn, params, x, src, g, selfattn):
    jp = jax.tree.map(jnp.asarray, params)

    def loss(p, xx, ss):
        return jnp.sum(fn(p, xx, xx if selfattn else ss) * jnp.asarray(g))

    gp, gx, gs = jax.grad(loss, (0, 1, 2))(jp, jnp.asarray(x), jnp.asarray(src))
    grads = {"x": np.asarray(gx)}
    if not selfattn:
        grads["src"] = np.asarray(gs)
    for nm in NAMES:
        grads[nm + ".w"] = np.asarray(gp[nm]["w"])
        grads[nm + ".b"] = np.asarray(gp[nm]["b"])
    return grads


CASES = [  # topk, masked, selfattn, batch
    pytest.param(None, False, False, 2, id="dense-cross"),
    pytest.param(6, False, False, 2, id="topk-cross"),
    pytest.param(6, True, False, 2, id="topk-masked-cross"),
    pytest.param(None, True, True, 2, id="dense-masked-self"),
    pytest.param(5, False, True, 2, id="topk-self"),
    # batch 8 > the TPU kernel's block of 4: its backward grid has two
    # programs and accumulates the weight gradients across them
    pytest.param(6, True, False, 8, id="topk-masked-cross-two-programs"),
]


@pytest.mark.parametrize("topk,masked,selfattn,b", CASES)
def test_fused_mha_twin_matches_pallas_kernels_f32(topk, masked, selfattn, b):
    """float32, tolerance 2e-5 (absolute and relative): both sides keep
    f32 internals and differ in the order of their sums."""
    n, m, d, heads = 12, 16, 16, 4
    params, x, src, g, mask = _case(900 + (topk or 0) + b, b, n, m, d, masked,
                                    selfattn, np.float32)
    attn, convs = _port_attn(params, torch.float32)
    jp = jax.tree.map(jnp.asarray, params)
    jmask = None if mask is None else jnp.asarray(mask)
    out_j, thr_j, lse_j = _mha_fwd_call(jp, jnp.asarray(x), jnp.asarray(src),
                                        jmask, topk, heads, True, True)

    xt, st = torch.from_numpy(x), torch.from_numpy(src)
    mt = None if mask is None else torch.from_numpy(mask)
    out, thr, lse = fused_mha_forward(xt, st, mt, topk, heads,
                                      *blocked_weights(attn, heads))
    tol = dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **tol)
    np.testing.assert_allclose(thr.numpy(), np.asarray(thr_j), **tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), **tol)

    want = _jax_grads(lambda p, xx, ss: jax_fused_mha(topk, heads, True, p, xx,
                                                      ss, jmask),
                      params, x, src, g, selfattn)
    out2, got = _port_grads(attn, convs, x, src, g, mask, topk, heads,
                            selfattn, _fused)
    np.testing.assert_allclose(out2, np.asarray(out_j), **tol)
    assert sorted(got) == sorted(want) and len(got) == (9 if selfattn else 10)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **tol)


def test_fused_mha_all_masked_cloud_matches_pallas_kernels():
    """A cloud with no valid key: thr = +1e30, lse = -1e30, the output is
    the merge bias, and its rows add nothing to any gradient."""
    n, m, d, heads, topk = 12, 16, 16, 4, 6
    params, x, src, g, mask = _case(950, 3, n, m, d, True, False, np.float32,
                                    dead_row=True)
    attn, convs = _port_attn(params, torch.float32)
    jp = jax.tree.map(jnp.asarray, params)
    jmask = jnp.asarray(mask)
    out_j, thr_j, lse_j = _mha_fwd_call(jp, jnp.asarray(x), jnp.asarray(src),
                                        jmask, topk, heads, True, True)
    out, thr, lse = fused_mha_forward(torch.from_numpy(x), torch.from_numpy(src),
                                      torch.from_numpy(mask), topk, heads,
                                      *blocked_weights(attn, heads))
    assert (thr[-1] == 1e30).all() and (lse[-1] == -1e30).all()
    np.testing.assert_array_equal(thr[-1].numpy(), np.asarray(thr_j)[-1])
    np.testing.assert_array_equal(lse[-1].numpy(), np.asarray(lse_j)[-1])
    np.testing.assert_allclose(out[-1].numpy(),
                               np.broadcast_to(params["merge"]["b"], (n, d)),
                               rtol=0, atol=1e-6)
    tol = dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **tol)
    want = _jax_grads(lambda p, xx, ss: jax_fused_mha(topk, heads, True, p, xx,
                                                      ss, jmask),
                      params, x, src, g, False)
    _, got = _port_grads(attn, convs, x, src, g, mask, topk, heads, False,
                         _fused)
    assert not got["x"][-1].any() and not got["src"][-1].any()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **tol)


@pytest.mark.parametrize("topk,masked,selfattn,b", CASES[:5])
def test_fused_mha_twin_and_plain_path_match_xla_autodiff_f64(topk, masked,
                                                              selfattn, b):
    """float64, tolerance 1e-9: the twin (blocked weights, folded scale)
    and the plain split-heads path both equal ``jax.grad`` through the
    JAX package's XLA attention."""
    n, m, d, heads = 12, 16, 16, 4
    params, x, src, g, mask = _case(970 + (topk or 0), b, n, m, d, masked,
                                    selfattn, np.float64)
    jmask = None if mask is None else jnp.asarray(mask)
    want = _jax_grads(lambda p, xx, ss: jax_mha(p, xx, ss, topk,
                                                num_heads=heads, kv_mask=jmask),
                      params, x, src, g, selfattn)
    ref = np.asarray(jax_mha(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                             jnp.asarray(src), topk, num_heads=heads,
                             kv_mask=jmask))
    for fn in (_fused, _plain):
        attn, convs = _port_attn(params, torch.float64)
        out, got = _port_grads(attn, convs, x, src, g, mask, topk, heads,
                               selfattn, fn)
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-9)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-9,
                                       err_msg=f"{fn.__name__} {key}")


def test_selection_is_frozen_between_forward_and_backward():
    """The backward keeps exactly the entries the forward kept: rebuilt
    from the residuals as ``mask & (s >= thr)``, every row holds k entries
    (ties aside), and ``exp(s - lse)`` over them sums to one."""
    n, m, d, heads, topk = 12, 16, 16, 4, 6
    params, x, src, _, mask = _case(990, 2, n, m, d, True, False, np.float32)
    attn, _ = _port_attn(params, torch.float32)
    w = blocked_weights(attn, heads)
    xt, st, mt = map(torch.from_numpy, (x, src, mask))
    with torch.no_grad():
        _, thr, lse = fused_mha_forward(xt, st, mt, topk, heads, *w)
        q = (xt @ w[0] + w[1]).reshape(2, n, heads, -1).transpose(1, 2)
        k = (st @ w[2] + w[3]).reshape(2, m, heads, -1).transpose(1, 2)
        s = q @ k.transpose(-1, -2)
        keep = mt[:, None, None, :] & (s >= thr)
        p = torch.where(keep, torch.exp(s - lse), 0.0)
    assert (keep.sum(-1) == topk).all()
    np.testing.assert_allclose(p.sum(-1).numpy(), 1.0, rtol=0, atol=1e-5)
