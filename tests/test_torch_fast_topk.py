"""Port parity of the attention kernel's fast top-k arm, the value
bisection that the JAX package runs by default on its accelerator
(``_stacked_prob(exact=False)``), on the CPU: the port's threshold twin
``ops/attention.py::fast_threshold`` against the JAX selection core itself,
the four call sites (the attention kernel, the eval layer, the fused-MHA
pair and the whole-layer train kernels, each through its plain twin)
against the JAX Pallas kernels in interpret mode, and the resolution each
route keys on its input. The slice as a whole and the switch are in
``tests/test_torch_fast_topk_model.py``.

The JAX selection core runs eagerly here (``jax.disable_jit``): compiled,
XLA's CPU backend contracts each midpoint ``lo + c * (hi - lo)`` into one
fused multiply-add, where the JAX source, the twin and the CUDA kernel round
the product and the sum apart, so a compiled run's threshold can sit one
ulp away from the twin's (held to that ulp below). The Pallas kernels in
interpret mode are compiled, so the module tests hold thr to a tolerance.
"""

import inspect

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mdgat_tpu.ops.pallas.attention as PA
from mdgat_tpu.models.gnn import attentional_propagation_init
from mdgat_tpu.ops.pallas.attention import (_mha_fwd_call,
                                            fused_layer_apply,
                                            fused_mha as jax_fused_mha,
                                            fused_train_layer_apply,
                                            pallas_topk_attention)

from mdgat_tpu_torch.core.checkpoint import propagation_state_dict
from mdgat_tpu_torch.models.gnn import AttentionalPropagation
from mdgat_tpu_torch.ops.attention import (BIG_NEG, attention_core,
                                           fast_iters, fast_plan,
                                           fast_threshold, topk_threshold)
from mdgat_tpu_torch.ops.cuda import attention as attn_kernel
from mdgat_tpu_torch.ops.cuda import layer as layer_kernel
from mdgat_tpu_torch.ops.cuda import mha
from mdgat_tpu_torch.ops.cuda import train_layer as T

# (score dtype, resolution): f32 scores of a float32 input, f32 scores
# keyed on a bfloat16 input, float64 scores
ARMS = [pytest.param(np.float32, 5, id="f32"),
        pytest.param(np.float32, 4, id="bf16-keyed"),
        pytest.param(np.float64, 14, id="f64")]
KEYS = (7, 64, 256, 512, 513, 1024, 1025)


def _scores(seed, m, dt):
    """Masked scores [24, m] with ragged masks, an all-masked row, an
    all-tied row, exact duplicates at the boundary, signed zeros and a row
    of zeros only, and their validity."""
    rng = np.random.default_rng(seed)
    s = (rng.normal(size=(24, m)) * 3).astype(dt)
    s[3] = 1.25                                   # every key tied
    s[4, ::2], s[4, 1::2] = -0.0, 0.0             # signed zeros only
    s[6, : m // 2] = np.round(s[6, : m // 2])     # duplicates everywhere
    s[7, : m // 2] = -0.0                         # a run of negative zeros
    s[8] = np.sort(s[8])[::-1]
    s[8, 7:10] = s[8, min(7, m - 1)]              # ties at the 8th value
    valid = rng.uniform(size=s.shape) > 0.3
    valid[5] = False                              # all masked
    valid[3] = valid[4] = valid[8] = True
    return np.where(valid, s, BIG_NEG).astype(dt), valid


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.int64 if a.dtype == np.float64 else np.int32)


@pytest.mark.parametrize("m", KEYS)
@pytest.mark.parametrize("dt,fine", ARMS)
def test_fast_threshold_bit_equal_to_stacked_prob(dt, fine, m):
    """thr bit for bit, the probabilities ``e * inv`` and ``lse`` to 1e-6
    (f32) / 1e-12 (f64), for k = 1, 8 and above every row's valid count;
    the kept set holds the exact top-k on every row, and with fewer valid
    keys than k it is every valid key, as the exact arm keeps."""
    sm, valid = _scores(1000 + m + fine, m, dt)
    st, vt = torch.from_numpy(sm), torch.from_numpy(valid)
    tol = 1e-6 if dt == np.float32 else 1e-12
    for k in (1, 8, m + 3):
        with jax.disable_jit():
            e, inv, thr, lse = PA._stacked_prob(
                jnp.asarray(sm), jnp.asarray(valid), topk=k, exact=False,
                has_mask=True, fine_iters=fine)
        got = fast_threshold(st, vt, k, fine).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(np.asarray(thr)))
        p, thr2, lse2 = _core(st, vt, k, fine)
        np.testing.assert_array_equal(_bits(thr2), _bits(got))
        np.testing.assert_allclose(p, np.asarray(e) * np.asarray(inv),
                                   rtol=0, atol=tol)
        live = valid.any(1)
        np.testing.assert_allclose(lse2[live], np.asarray(lse)[live, 0],
                                   rtol=0, atol=tol)
        assert not p[5].any()                     # all-masked row
        exact = topk_threshold(st, vt, k).numpy()
        kept = valid & (sm >= got)
        assert (kept | ~(valid & (sm >= exact))).all()   # holds the top-k
        assert (kept.sum(1)[live] >= np.minimum(valid.sum(1), k)[live]).all()
        if k > m:
            np.testing.assert_array_equal(kept, valid)


def _core(st, vt, k, fine):
    """(probabilities [R, M], thr [R, 1], lse [R]) of ``attention_core``'s
    fast arm on masked scores ``st`` [R, M]: an identity V returns the
    probabilities themselves."""
    r, m = st.shape
    out, thr, lse = attention_core(
        st[:, None, None, :], torch.eye(m, dtype=st.dtype)[None, None], vt,
        k, return_lse=True, fine_iters=fine)      # a batch entry a row
    return (out[:, 0, 0].numpy(), thr[:, 0, 0].numpy(),
            lse[:, 0, 0, 0].numpy())


def test_compiled_stacked_prob_within_one_ulp_of_the_twin():
    """Compiled, the JAX selection core's midpoints are fused
    multiply-adds (XLA's CPU backend contracts them): thr within one ulp
    of the twin's, and the kept sets equal wherever no score lies between
    the two thresholds."""
    sm, valid = _scores(77, 256, np.float32)
    st, vt = torch.from_numpy(sm), torch.from_numpy(valid)
    _, _, thr, _ = PA._stacked_prob(jnp.asarray(sm), jnp.asarray(valid),
                                    topk=8, exact=False, has_mask=True,
                                    fine_iters=5)
    thr = np.asarray(thr)
    got = fast_threshold(st, vt, 8, 5).numpy()
    assert (np.abs(_bits(got) - _bits(thr)) <= 1).all()
    lo, hi = np.minimum(got, thr), np.maximum(got, thr)
    between = ((sm >= lo) & (sm < hi) & valid).any(1)
    np.testing.assert_array_equal(((sm >= got) & valid)[~between],
                                  ((sm >= thr) & valid)[~between])


@pytest.mark.parametrize("m,mids,passes", [
    (7, 2, 4), (512, 2, 4), (513, 1, 5), (1024, 1, 5), (1025, 1, 5)])
def test_fast_plan_arity_and_passes(m, mids, passes):
    """Ternary through 512 keys, binary beyond (``_KARY_MAX_M``); passes
    ceil(fine / log2(n_mid + 1)): 3 / 4 / 9 ternary at bf16 / f32 / f64."""
    assert fast_plan(m, 5) == (mids, passes)
    assert fast_iters(torch.bfloat16) == 4 == PA._fast_iters(jnp.bfloat16)
    assert fast_iters(torch.float32) == 5 == PA._fast_iters(np.float32)
    assert fast_iters(torch.float64) == 14 == PA._fast_iters(np.float64)
    assert fast_plan(256, 4)[1] == 3 and fast_plan(256, 14)[1] == 9


# ---------------------------------------------------------------------------
# the four call sites against the JAX Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_attention_kernel_twin_matches_pallas_fast_arm(masked):
    """``pallas_topk_attention(exact=False)`` against
    ``topk_attention_reference(exact=False)``, float32, k = 8 of 40 keys:
    output and thr to 2e-5 (the tolerance of the exact arm's test)."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 2, 24, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 2, 40, 16)).astype(np.float32)
            for _ in range(2))
    mask = (np.arange(40)[None] < np.array([[40], [29]])) if masked else None
    want, thr_j = pallas_topk_attention(
        *(jnp.asarray(a) for a in (q, k, v)), 8,
        kv_mask=None if mask is None else jnp.asarray(mask), interpret=True,
        return_threshold=True, exact=False)
    got, thr = attn_kernel.topk_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)),
        None if mask is None else torch.from_numpy(mask), 8, 16 ** -0.5,
        exact=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(thr.numpy(), np.asarray(thr_j), rtol=2e-5,
                               atol=2e-5)
    _, thr_exact = attn_kernel.topk_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)),
        None if mask is None else torch.from_numpy(mask), 8, 16 ** -0.5)
    assert (thr <= thr_exact).all() and not torch.equal(thr, thr_exact)


D, H = 32, 4


def _jax_layer(seed, np_dtype=np.float32):
    params, state = attentional_propagation_init(
        jax.random.PRNGKey(seed), D, H, dtype=jnp.dtype(np_dtype))
    params = jax.tree.map(np.asarray, params)
    state = jax.tree.map(np.asarray, state)
    rng = np.random.default_rng(seed)
    params["mlp"][0]["bn"] = {
        "scale": rng.uniform(0.5, 1.5, 2 * D).astype(np_dtype),
        "bias": (rng.normal(size=2 * D) * 0.2).astype(np_dtype)}
    state["mlp"][0] = {"mean": (rng.normal(size=2 * D) * 0.3).astype(np_dtype),
                       "var": rng.uniform(0.5, 1.5, 2 * D).astype(np_dtype)}
    tdt = torch.float64 if np_dtype == np.float64 else torch.float32
    port = AttentionalPropagation(D, H, dtype=tdt)
    port.load_state_dict(propagation_state_dict(params, state), strict=True)
    return params, state, port


def test_eval_layer_twin_matches_pallas_fast_arm_bf16_input():
    """``fused_layer_apply(exact=False)`` against ``fused_layer(exact=False)``
    on a bfloat16 input, whose resolution (4 binary passes) is keyed on
    ``x``, not on the float32 projections the attention is given: the
    outputs to the bf16 rounding of entries up to ~8."""
    params, state, port = _jax_layer(21)
    rng = np.random.default_rng(22)
    x, src = rng.normal(size=(2, 24, D)), rng.normal(size=(2, 40, D))
    mask = np.arange(40)[None] < np.array([[40], [31]])
    xb = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    sb = torch.from_numpy(src.astype(np.float32)).to(torch.bfloat16)
    want = fused_layer_apply(
        params, state, jnp.asarray(xb.float().numpy(), jnp.bfloat16),
        jnp.asarray(sb.float().numpy(), jnp.bfloat16), 8, H,
        kv_mask=jnp.asarray(mask), exact=False, interpret=True)
    got = layer_kernel.fused_layer(xb, sb, torch.from_numpy(mask), 8,
                                   layer_kernel.prepare_layer_weights(port),
                                   exact=False)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=6e-2)


def test_routes_key_the_resolution_on_their_input(monkeypatch):
    """Each route gives the attention the resolution of its own input's
    dtype (the JAX kernels' ``_fast_iters(x_ref.dtype)``), the exact arm
    0; the attention kernel alone keys it on q."""
    seen = []
    real = attn_kernel.topk_attention_reference
    signature = inspect.signature(real)

    def spy(*args, **kw):
        a = signature.bind(*args, **kw)
        a.apply_defaults()
        seen.append(attn_kernel.resolution(args[0].dtype, a.arguments["exact"],
                                           a.arguments["fine_iters"]))
        return real(*args, **kw)

    monkeypatch.setattr(attn_kernel, "topk_attention_reference", spy)
    _, _, port = _jax_layer(23)
    w = layer_kernel.prepare_layer_weights(port)
    for dt in (torch.bfloat16, torch.float32):
        x = torch.randn(1, 8, D, dtype=torch.float32).to(dt)
        for exact in (False, True):
            layer_kernel.fused_layer(x, x, None, 4, w, exact=exact)
    q = torch.randn(1, 1, 8, 8).to(torch.bfloat16)
    attn_kernel.topk_attention(q, q, q, None, 4, 1.0, exact=False)
    assert seen == [4, 0, 5, 0, 4]


def _mha_params(seed, d):
    rng = np.random.default_rng(seed)
    return {nm: {"w": (rng.uniform(-1, 1, (d, d)) / np.sqrt(d)).astype(np.float32),
                 "b": (rng.uniform(-1, 1, d) / np.sqrt(d)).astype(np.float32)}
            for nm in ("q", "k", "v", "merge")}


def _port_mha(params, d):
    from mdgat_tpu_torch.models.gnn import MultiHeadedAttention
    attn = MultiHeadedAttention(d, dtype=torch.float32)
    with torch.no_grad():
        for conv, nm in zip(list(attn.proj) + [attn.merge],
                            ("q", "k", "v", "merge")):
            conv.weight.copy_(torch.from_numpy(params[nm]["w"].T[:, :, None].copy()))
            conv.bias.copy_(torch.from_numpy(params[nm]["b"]))
    return attn


def test_fused_mha_twin_matches_pallas_fast_arm_with_gradients():
    """The fused-MHA forward (out, thr, lse) and all ten gradients, fast
    arm, float32, against ``fused_mha(exact=False)`` in interpret mode, to
    the exact arm's tolerance 2e-5."""
    d, heads, b, n, m = 16, 4, 2, 12, 16
    params = _mha_params(31, d)
    rng = np.random.default_rng(32)
    x, src = rng.normal(size=(b, n, d)), rng.normal(size=(b, m, d))
    x, src = x.astype(np.float32), src.astype(np.float32)
    g = rng.normal(size=(b, n, d)).astype(np.float32)
    mask = np.ones((b, m), bool)
    mask[0, m - 3:] = False
    jp = jax.tree.map(jnp.asarray, params)
    out_j, thr_j, lse_j = _mha_fwd_call(jp, jnp.asarray(x), jnp.asarray(src),
                                        jnp.asarray(mask), 6, heads, False,
                                        True)
    attn = _port_mha(params, d)
    xt = torch.from_numpy(x).requires_grad_()
    st = torch.from_numpy(src).requires_grad_()
    w = mha.blocked_weights(attn, heads)
    out, thr, lse = mha.fused_mha_forward(xt.detach(), st.detach(),
                                          torch.from_numpy(mask), 6, heads,
                                          *w, exact=False)
    tol = dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **tol)
    np.testing.assert_allclose(thr.numpy(), np.asarray(thr_j), **tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), **tol)

    def jloss(p, xx, ss):
        return jnp.sum(jax_fused_mha(6, heads, False, p, xx, ss,
                                     jnp.asarray(mask)) * jnp.asarray(g))

    gp, gx, gs = jax.grad(jloss, (0, 1, 2))(jp, jnp.asarray(x),
                                             jnp.asarray(src))
    y = mha.fused_mha(xt, st, torch.from_numpy(mask), 6, heads,
                      *mha.blocked_weights(attn, heads), exact=False)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **tol)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(gs), **tol)
    for conv, nm in zip(list(attn.proj) + [attn.merge],
                        ("q", "k", "v", "merge")):
        np.testing.assert_allclose(conv.weight.grad[:, :, 0].t().numpy(),
                                   np.asarray(gp[nm]["w"]), err_msg=nm, **tol)
        np.testing.assert_allclose(conv.bias.grad.numpy(),
                                   np.asarray(gp[nm]["b"]), err_msg=nm, **tol)


def test_train_layer_twin_matches_pallas_fast_arm_f64():
    """The whole-layer train kernels, fast arm, float64 input (14 binary
    passes, 9 ternary): ``fused_train_layer_apply(exact=False)`` in
    interpret mode against the port's ``fused_train_layer_apply(exact=
    False)``. The Pallas kernels compute in float32 whatever their input
    (the twin keeps float64), so y, the running statistics and every
    gradient are held to the float32 tolerances of the exact arm's test
    against these kernels (``tests/test_torch_train_layer.py``)."""
    params, state, port = _jax_layer(41, np.float64)
    port.train()
    rng = np.random.default_rng(42)
    b, n, m = 2, 24, 20
    x, src = rng.normal(size=(b, n, D)), rng.normal(size=(b, m, D))
    g = rng.normal(size=(b, n, D))
    vm = np.arange(n)[None] < np.array([[24], [17]])
    km = np.arange(m)[None] < np.array([[20], [13]])
    js = jax.tree.map(jnp.asarray, state)

    def loss(p, xx, ss):
        y, nst = fused_train_layer_apply(
            p, js, xx, ss, 6, H, valid_mask=jnp.asarray(vm),
            kv_mask=jnp.asarray(km), exact=False, interpret=True)
        return jnp.sum(y * jnp.asarray(g)), (y, nst)

    (_, (y_j, st_j)), (gp, gx, gs) = jax.value_and_grad(
        loss, (0, 1, 2), has_aux=True)(jax.tree.map(jnp.asarray, params),
                                       jnp.asarray(x), jnp.asarray(src))
    xt = torch.from_numpy(x).requires_grad_()
    st = torch.from_numpy(src).requires_grad_()
    y = T.fused_train_layer_apply(port, xt, st, 6, torch.from_numpy(km),
                                  torch.from_numpy(vm), exact=False)
    (y * torch.from_numpy(g)).sum().backward()
    tol = dict(rtol=3e-4, atol=3e-5)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               rtol=2e-5, atol=2e-5)
    bn = port.mlp[1]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(st_j["mlp"][0]["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(st_j["mlp"][0]["var"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **tol)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(gs), **tol)
    named = propagation_state_dict(jax.tree.map(np.asarray, gp), state)
    for key, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), named[key].numpy(),
                                   err_msg=key, **tol)
