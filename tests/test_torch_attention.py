"""Port parity: attention (``mdgat_tpu_torch.ops.attention`` and the twin of
the CUDA attention kernel) against the JAX package's XLA attention and its
exact Pallas kernel, run in interpret mode as ``tests/test_pallas.py`` runs
it. Inputs are made with numpy from a seed and fed to both packages."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mdgat_tpu.ops.attention import full_attention as jax_full
from mdgat_tpu.ops.attention import topk_attention as jax_topk
from mdgat_tpu.ops.pallas import pallas_topk_attention

from mdgat_tpu_torch.ops import attention as port
from mdgat_tpu_torch.ops.cuda import attention as kernel

B, H, N, M, DH = 3, 4, 24, 40, 8
COUNTS = (40, 29, 17)   # valid keys per batch element


def _inputs(seed, dtype=np.float64, counts=COUNTS):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, N, DH)).astype(dtype)
    k = rng.normal(size=(B, H, M, DH)).astype(dtype)
    v = rng.normal(size=(B, H, M, DH)).astype(dtype)
    mask = np.arange(M)[None, :] < np.asarray(counts)[:, None]
    return q, k, v, mask


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("topk", [None, 8])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_attention_matches_xla_f64(topk, masked):
    q, k, v, mask = _inputs(401)
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    tq, tk, tv = _t(q, k, v)
    if topk is None:
        ref = jax_full(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm)
        got = port.full_attention(tq, tk, tv, tm)
    else:
        ref = jax_topk(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), topk,
                       kv_mask=jm)
        got = port.topk_attention(tq, tk, tv, topk, tm)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-9)


def _pallas(q, k, v, mask, topk):
    return pallas_topk_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), topk,
        kv_mask=None if mask is None else jnp.asarray(mask), interpret=True,
        exact=True, return_threshold=True)


@pytest.mark.parametrize("topk", [None, 8])
def test_kernel_twin_matches_exact_pallas_f32(topk):
    """f32 internals on both sides; the twin keeps f32 as the kernel does."""
    q, k, v, mask = _inputs(402, np.float32)
    ref_o, ref_t = _pallas(q, k, v, mask, topk)
    tq, tk, tv, tm = _t(q, k, v, mask)
    o, thr = kernel.topk_attention(tq, tk, tv, tm, topk or 0, DH ** -0.5)
    assert o.dtype == torch.float32 and thr.shape == (B, H, N, 1)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(thr.numpy(), np.asarray(ref_t), rtol=0,
                               atol=2e-5)


def _key_values(m, seed):
    """Scores that a unit query over head dim 1 reproduces exactly: exact
    ties and 1-ulp gaps at the boundary, negatives."""
    rng = np.random.default_rng(seed)
    vals = (rng.normal(size=(m,)) * 10).astype(np.float32)
    vals[10] = vals[11]
    vals[12] = np.nextafter(vals[11], np.float32(1e30))
    vals[13] = np.nextafter(vals[11], np.float32(-1e30))
    vals[20:24] = -np.abs(vals[20:24])
    return vals


@pytest.mark.parametrize("topk", [1, 5, 33, 63])
def test_threshold_bit_equal_to_exact_pallas(topk):
    """Where the JAX exact kernel is exact (scores reproduced bit for bit:
    unit queries, head dim 1), the twin's threshold is bit-equal to it and
    to the sorted k-th value, and the kept set is every entry >= it."""
    m = 64
    vals = _key_values(m, 403)
    q = np.ones((1, 1, 4, 1), np.float32)
    k = vals.reshape(1, 1, m, 1)
    v = np.random.default_rng(404).normal(size=(1, 1, m, 1)).astype(np.float32)
    mask = np.ones((1, m), bool)
    ref_o, ref_t = _pallas(q, k, v, mask, topk)
    tq, tk, tv, tm = _t(q, k, v, mask)
    o, thr = kernel.topk_attention(tq, tk, tv, tm, topk, 1.0)
    expect = np.sort(vals)[::-1][topk - 1]
    assert (thr.numpy() == expect).all()
    assert (thr.numpy() == np.asarray(ref_t)).all()
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o), rtol=0,
                               atol=2e-6)


def test_ties_at_kth_value_all_kept():
    """Five keys share the k-th value: all five are kept (more than k),
    in both packages."""
    m, topk = 16, 3
    vals = np.arange(m, dtype=np.float32) * 0.5
    vals[[2, 5, 7, 9, 11]] = 20.0            # the 1st..5th largest tie
    q = np.ones((1, 1, 2, 1), np.float32)
    k = vals.reshape(1, 1, m, 1)
    v = np.eye(m, dtype=np.float32)[:, :1].reshape(1, 1, m, 1) + \
        np.arange(m, dtype=np.float32).reshape(1, 1, m, 1)
    mask = np.ones((1, m), bool)
    ref_o, ref_t = _pallas(q, k, v, mask, topk)
    tq, tk, tv, tm = _t(q, k, v, mask)
    o, thr = kernel.topk_attention(tq, tk, tv, tm, topk, 1.0)
    assert (thr.numpy() == 20.0).all() and (np.asarray(ref_t) == 20.0).all()
    # mean of the five tied keys' values, not of three of them
    expect = np.mean(v[0, 0, [2, 5, 7, 9, 11], 0])
    np.testing.assert_allclose(o.numpy()[0, 0, :, 0], expect, rtol=1e-6)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o), rtol=0,
                               atol=2e-6)


def test_fewer_valid_keys_than_k_keeps_every_valid_key():
    q, k, v, _ = _inputs(405, np.float32)
    mask = np.arange(M)[None, :] < np.array([5, 7, 3])[:, None]
    topk = 8
    ref_o, ref_t = _pallas(q, k, v, mask, topk)
    tq, tk, tv, tm = _t(q, k, v, mask)
    o, thr = kernel.topk_attention(tq, tk, tv, tm, topk, DH ** -0.5)
    dense = kernel.topk_attention(tq, tk, tv, tm, 0, DH ** -0.5)[0]
    np.testing.assert_allclose(o.numpy(), dense.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o), rtol=0,
                               atol=2e-5)
    # threshold = smallest valid score, bit-equal to the exact kernel's
    # when both see the same scores (checked at the kernel's own scores
    # above; here to f32 rounding of the score products)
    np.testing.assert_allclose(thr.numpy(), np.asarray(ref_t), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("topk", [None, 8])
def test_all_masked_row_gives_zeros(topk):
    q, k, v, mask = _inputs(406, np.float32)
    mask[1] = False
    ref_o, _ = _pallas(q, k, v, mask, topk)
    tq, tk, tv, tm = _t(q, k, v, mask)
    o, _ = kernel.topk_attention(tq, tk, tv, tm, topk or 0, DH ** -0.5)
    assert np.isfinite(o.numpy()).all()
    assert (o.numpy()[1] == 0).all() and (np.asarray(ref_o)[1] == 0).all()
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o), rtol=0,
                               atol=2e-5)
    # the plain f64 path gives the same zeros
    tq, tk, tv, tm = _t(*(a.astype(np.float64) for a in (q, k, v)), mask)
    got = (port.full_attention(tq, tk, tv, tm) if topk is None
           else port.topk_attention(tq, tk, tv, topk, tm))
    assert (got.numpy()[1] == 0).all()


def test_wrapper_dispatch_by_device():
    """A CPU tensor takes the twin without counting a launch; a device
    with no kernel raises instead of falling back."""
    q, k, v, mask = _t(*_inputs(407, np.float32))
    before = kernel.topk_attention.launches
    o, _ = kernel.topk_attention(q, k, v, mask, 8, DH ** -0.5)
    ref, _ = kernel.topk_attention_reference(q, k, v, mask, 8, DH ** -0.5)
    assert torch.equal(o, ref)
    assert kernel.topk_attention.launches == before
    with pytest.raises(ValueError, match="no attention kernel"):
        kernel.topk_attention(q.to("meta"), k.to("meta"), v.to("meta"),
                              None, 8, 1.0)


def test_bf16_inputs_keep_f32_internals():
    q, k, v, mask = _t(*_inputs(408, np.float32))
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    o, thr = kernel.topk_attention(qb, kb, vb, mask, 8, DH ** -0.5)
    ref, _ = kernel.topk_attention(qb.float(), kb.float(), vb.float(), mask,
                                   8, DH ** -0.5)
    assert o.dtype == torch.bfloat16 and thr.dtype == torch.float32
    np.testing.assert_allclose(o.float().numpy(), ref.numpy(), rtol=1e-2,
                               atol=1e-2)


def test_split_merge_heads_roundtrip_torch_channel_order():
    x = torch.arange(2 * 5 * 12, dtype=torch.float64).reshape(2, 5, 12)
    s = port.split_heads(x, 4)
    assert s.shape == (2, 4, 5, 3)
    # channel c = d * H + h
    assert s[0, 1, 0, 2].item() == x[0, 0, 2 * 4 + 1].item()
    assert torch.equal(port.merge_heads(s), x)
