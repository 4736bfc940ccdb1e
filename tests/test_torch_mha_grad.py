"""Port parity of the fused multi-head attention used in training
(``mdgat_tpu_torch.ops.cuda.mha``): its plain twin, which is what the CUDA
kernels are held against on the card, against the JAX package's
``fused_mha`` Pallas kernel pair in interpret mode (float32) and against
autodiff through its XLA path (float64): the output, the residuals ``thr``
and ``lse``, and all ten gradients (x, source, four weights, four biases).
Also the twin of the two attention-backward kernels against autograd over
``attention_core`` at the frozen selection (float64), and the backward's
launch sequence run on the CPU (its GEMMs in plain PyTorch, the attention
backward and the transposed-A GEMM on their twins) against the Pallas VJP.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mdgat_tpu.ops.attention import multi_head_attention as jax_mha
from mdgat_tpu.ops.pallas.attention import _mha_fwd_call, fused_mha as jax_fused_mha

from mdgat_tpu_torch.models.gnn import MultiHeadedAttention
from mdgat_tpu_torch.ops.attention import attention_core, multi_head_attention
from mdgat_tpu_torch.ops.cuda import mha
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


ATTN_BWD_CASES = [  # topk, kind
    pytest.param(None, "ragged", id="dense-ragged"),
    pytest.param(5, "ragged", id="topk-ragged"),
    pytest.param(5, "ties", id="topk-ties"),
    pytest.param(20, "ragged", id="topk-above-valid-count"),
    pytest.param(None, "all-masked", id="dense-all-masked-entry"),
    pytest.param(5, "all-masked", id="topk-all-masked-entry"),
    # 300 keys span several key tiles of the card's keys kernel (64 or 128
    # keys a block); one batch entry keeps 40, so its tail blocks are wholly
    # masked and their dk, dv must come out as exact zeros
    pytest.param(None, "tail-masked", id="dense-masked-tail-tiles"),
    pytest.param(5, "tail-masked", id="topk-masked-tail-tiles"),
]


@pytest.mark.parametrize("topk,kind", ATTN_BWD_CASES)
def test_attention_backward_twin_matches_autograd_f64(topk, kind):
    """float64, tolerance 1e-12: ``_attention_backward`` on CPU tensors (its
    twin) gives the attention output and the gradients of ``sum(out * do)``
    in q, k and v that autograd takes through ``attention_core``, with thr
    and lse from that forward. "ties": integer q and k, so many scores tie
    exactly at the k-th value and every tie is kept on both sides.
    "tail-masked": 300 keys, the last batch entry with 40 valid ones."""
    b, h, n, dh = 3, 2, 7, 4
    m = 300 if kind == "tail-masked" else 11
    counts = [m, 150, 40] if kind == "tail-masked" else [m, 8, 5]
    rng = np.random.default_rng(1000 + (topk or 0) + len(kind))

    def t(*shape):
        x = rng.normal(size=shape)
        return torch.from_numpy(np.clip(np.round(x), -2, 2) if kind == "ties"
                                else x)

    q, k, v, do = t(b, h, n, dh), t(b, h, m, dh), t(b, h, m, dh), t(b, h, n, dh)
    mask = torch.from_numpy(np.arange(m)[None, :] < np.array(counts)[:, None])
    if kind == "all-masked":
        mask[-1] = False
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out, thr, lse = attention_core(leaves[0] @ leaves[1].transpose(-1, -2),
                                   leaves[2], mask, topk, return_lse=True)
    want = torch.autograd.grad(out, leaves, do)
    got = mha._attention_backward(q, k, v, do, mask, thr.detach(), lse.detach())
    blocked = lambda x: x.permute(0, 2, 1, 3).reshape(-1, h * dh)
    for name, a, r in zip(("o", "dq", "dk", "dv"), got,
                          (out.detach(),) + tuple(want)):
        assert a.shape == blocked(r).shape and a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), blocked(r).numpy(), rtol=0,
                                   atol=1e-12, err_msg=name)
    if kind == "all-masked":
        assert not got[0].reshape(b, n, -1)[-1].any()
        assert not got[3].reshape(b, m, -1)[-1].any()
    if kind == "tail-masked":   # every key past the entry's last valid one
        for grad in got[2:]:
            assert not grad.reshape(b, m, -1)[-1, counts[-1]:].any()
    if kind == "ties" and topk:
        s = q @ k.transpose(-1, -2)
        assert ((s == thr) & mask[:, None, None, :]).sum(-1).max() > 1


def _plain_gemm(a1, w, bias, *, a2=None, relu=False, res=None, out_dtype=None,
                a1_heads=0, out_heads=0, rows_per_batch=0, w_trans=False):
    """The modes of ``ops/cuda/layer.py::gemm`` in plain PyTorch, so that
    the backward's launch sequence runs on the CPU."""
    if a1_heads:
        bb, hh, nn, dd = a1.shape
        a = a1.permute(0, 2, 1, 3).reshape(bb * nn, hh * dd)
    else:
        a = a1.reshape(-1, a1.shape[-1])
    if a2 is not None:
        a = torch.cat([a, a2.reshape(a.shape[0], -1)], 1)
    y = a.float() @ (w.t() if w_trans else w)
    if bias is not None:
        y = y + bias
    if relu:
        y = torch.relu(y)
    if res is not None:
        y = res.reshape(y.shape) + y
    if out_heads:
        y = y.reshape(-1, rows_per_batch, out_heads, y.shape[1] // out_heads)
        y = y.permute(0, 2, 1, 3)
    return y.to(out_dtype or a1.dtype).contiguous()


@pytest.mark.parametrize("topk,masked,selfattn,b",
                         [CASES[2], CASES[3], CASES[5]])
def test_mha_backward_launches_on_cpu_match_pallas_vjp_f32(monkeypatch, topk,
                                                           masked, selfattn,
                                                           b):
    """float32, tolerance 2e-5 (absolute and relative), as the twin's test
    above: ``_mha_backward_launches`` with its GEMMs in plain PyTorch, the
    attention backward and the transposed-A GEMMs on their CPU twins,
    against ``jax.vjp`` of the Pallas ``fused_mha`` in interpret mode; and
    the attention output it rebuilds from thr and lse, merged, equals the
    forward's output."""
    n, m, d, heads = 12, 16, 16, 4
    params, x, src, g, mask = _case(1100 + (topk or 0) + b, b, n, m, d,
                                    masked, selfattn, np.float32)
    attn, convs = _port_attn(params, torch.float32)
    w = blocked_weights(attn, heads)
    wd = [p.detach() for p in w]
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    st = xt if selfattn else torch.from_numpy(src)
    mt = None if mask is None else torch.from_numpy(mask)
    monkeypatch.setattr(mha, "gemm", _plain_gemm)
    f32 = torch.float32
    # the forward on the q, k, v the backward recomputes: the same bits
    q = _plain_gemm(xt, wd[0], wd[1], out_dtype=f32, out_heads=heads,
                    rows_per_batch=n)
    k = _plain_gemm(st, wd[2], wd[3], out_dtype=f32, out_heads=heads,
                    rows_per_batch=st.shape[1])
    v = _plain_gemm(st, wd[4], wd[5], out_dtype=f32, out_heads=heads,
                    rows_per_batch=st.shape[1])
    o_fwd, thr, lse = attention_core(q @ k.transpose(-1, -2), v, mt, topk,
                                     return_lse=True)
    (dx, dsrc, *wgrads, o) = mha._mha_backward_launches(
        xt, st, mt, thr, lse, gt, heads, *wd[:7])
    torch.autograd.backward(w, wgrads)          # to the Conv1x1 parameters
    got = {"x": (dx + dsrc if selfattn else dx).numpy()}
    if not selfattn:
        got["src"] = dsrc.numpy()
    for conv, nm in zip(convs, NAMES):
        got[nm + ".w"] = conv.weight.grad[:, :, 0].t().numpy()
        got[nm + ".b"] = conv.bias.grad.numpy()
    jmask = None if mask is None else jnp.asarray(mask)
    want = _jax_grads(lambda p, xx, ss: jax_fused_mha(topk, heads, True, p, xx,
                                                      ss, jmask),
                      params, x, src, g, selfattn)
    tol = dict(rtol=2e-5, atol=2e-5)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **tol)
    np.testing.assert_allclose(
        o.numpy(), o_fwd.permute(0, 2, 1, 3).reshape(b * n, d).numpy(),
        rtol=0, atol=1e-6)
