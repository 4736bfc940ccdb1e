"""Port parity of the trainable transport: the plain
``log_optimal_transport`` under autograd (the twin the CUDA replay-backward
kernel is held against on the card, and the CPU path of
``log_optimal_transport_kernel``) against the JAX package's
``pallas_log_optimal_transport_trainable`` (forward kernel + replay
backward kernel, interpret mode, float32) and against ``jax.grad`` through
the XLA scan (float64): ``dscores`` and ``dalpha``, masked and ragged.

Cotangents are zero on padded rows and columns, as every loss makes them.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mdgat_tpu.ops.pallas import pallas_log_optimal_transport_trainable
from mdgat_tpu.ops.transport import log_optimal_transport as jax_ot

from mdgat_tpu_torch.ops.cuda.sinkhorn import log_optimal_transport_kernel
from mdgat_tpu_torch.ops.transport import log_optimal_transport


def _case(seed, b, n, m, counts0, counts1, np_dtype):
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(b, n, m)).astype(np_dtype)
    rm = cm = None
    if counts0 is not None:
        rm = np.arange(n)[None, :] < np.asarray(counts0)[:, None]
        cm = np.arange(m)[None, :] < np.asarray(counts1)[:, None]
    r = np.ones((b, n), bool) if rm is None else rm
    c = np.ones((b, m), bool) if cm is None else cm
    cot = dict(dense=rng.normal(size=(b, n, m)) * (r[:, :, None] & c[:, None, :]),
               bin_row=rng.normal(size=(b, m)) * c,
               bin_col=rng.normal(size=(b, n)) * r,
               corner=rng.normal(size=(b,)))
    return scores, rm, cm, {k: v.astype(np_dtype) for k, v in cot.items()}


def _weighted(ot, cot, xp):
    return sum(xp.sum(getattr(ot, k) * cot[k]) for k in cot)


def _port_grads(fn, scores, alpha, iters, rm, cm, cot):
    s = torch.from_numpy(scores).requires_grad_()
    a = torch.tensor(alpha, dtype=s.dtype, requires_grad=True)
    masks = [None if x is None else torch.from_numpy(x) for x in (rm, cm)]
    ot = fn(s, a, iters, *masks)
    _weighted(ot, {k: torch.from_numpy(v) for k, v in cot.items()},
              torch).backward()
    return ot, s.grad.numpy(), a.grad.item()


def _jax_grads(fn, scores, alpha, iters, rm, cm, cot):
    masks = [None if x is None else jnp.asarray(x) for x in (rm, cm)]
    jcot = {k: jnp.asarray(v) for k, v in cot.items()}

    def loss(s, a):
        return _weighted(fn(s, a, iters, *masks), jcot, jnp)

    ds, da = jax.grad(loss, (0, 1))(jnp.asarray(scores),
                                    jnp.asarray(alpha, scores.dtype))
    return np.asarray(ds), float(da)


CASES = [  # b, n, m, counts0, counts1, iters
    pytest.param(2, 16, 16, None, None, 5, id="square-unmasked"),
    pytest.param(3, 24, 16, (24, 17, 9), (16, 11, 16), 5, id="ragged-masked"),
    pytest.param(2, 9, 20, (9, 4), (13, 20), 3, id="wide-masked"),
    # the model's own default iteration count, beyond what a history kept in
    # one block's shared memory allowed the card's replay backward at M = 512
    pytest.param(2, 12, 20, (12, 7), (20, 13), 100, id="ragged-100-iterations"),
]


@pytest.mark.parametrize("b,n,m,c0,c1,iters", CASES)
def test_transport_gradients_match_pallas_replay_backward_f32(b, n, m, c0, c1,
                                                              iters):
    """float32, tolerance 2e-5 (absolute, and relative for the summed
    dalpha): both sides differentiate the same unrolled loop exactly and
    differ in the order of their f32 sums."""
    scores, rm, cm, cot = _case(1100 + n, b, n, m, c0, c1, np.float32)
    want_ds, want_da = _jax_grads(
        lambda s, a, it, r, c: pallas_log_optimal_transport_trainable(
            s, a, it, r, c, interpret=True), scores, 0.7, iters, rm, cm, cot)
    # the CPU path of the trainable entry is the plain transport
    _, got_ds, got_da = _port_grads(log_optimal_transport_kernel, scores,
                                    0.7, iters, rm, cm, cot)
    np.testing.assert_allclose(got_ds, want_ds, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_da, want_da, rtol=2e-5, atol=2e-5)
    if rm is not None:   # dscores is zero outside the valid block
        valid = rm[:, :, None] & cm[:, None, :]
        assert not got_ds[~valid].any() and not want_ds[~valid].any()


@pytest.mark.parametrize("b,n,m,c0,c1,iters", CASES)
def test_transport_gradients_match_xla_scan_f64(b, n, m, c0, c1, iters):
    """float64, tolerance 1e-9, values and gradients."""
    scores, rm, cm, cot = _case(1200 + n, b, n, m, c0, c1, np.float64)
    want_ds, want_da = _jax_grads(jax_ot, scores, 1.3, iters, rm, cm, cot)
    ot, got_ds, got_da = _port_grads(log_optimal_transport, scores, 1.3, iters,
                                     rm, cm, cot)
    masks = [None if x is None else jnp.asarray(x) for x in (rm, cm)]
    ref = jax_ot(jnp.asarray(scores), jnp.asarray(1.3), iters, *masks)
    valid = (np.ones(scores.shape, bool) if rm is None
             else rm[:, :, None] & cm[:, None, :])
    np.testing.assert_allclose(ot.dense.detach().numpy()[valid],
                               np.asarray(ref.dense)[valid], rtol=0, atol=1e-9)
    np.testing.assert_allclose(got_ds, want_ds, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got_da, want_da, rtol=0, atol=1e-9)


def test_trainable_entry_refuses_what_its_kernels_cannot_take():
    """Off the CPU there is no fallback: a device without the kernels, or
    a vector alpha, raises."""
    s = torch.zeros((1, 4, 4), device="meta")
    with pytest.raises(ValueError, match="no Sinkhorn kernel"):
        log_optimal_transport_kernel(s, 1.0, 3)
