"""Port parity of the gap-loss margin kernels' plain twins
(``mdgat_tpu_torch/ops/cuda/gap_loss.py``) against the JAX package: the
forward twin against ``fused_gap_margins`` (the Pallas kernel in interpret
mode) at float32, ``gap_loss_kernel`` against the XLA ``gap_loss`` at float64,
the backward twin against ``jax.vjp`` of ``fused_gap_margins`` and against
``torch.autograd`` over the port's ``gap_loss``. The same numpy arrays, made
from a seed, go into both packages. On the CPU the wrappers take the twins;
the CUDA kernels are held against the twins on the card by ``chip_smoke.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mdgat_tpu.ops.losses import gap_loss as jax_gap_loss
from mdgat_tpu.ops.pallas.loss import fused_gap_margins as jax_fused_gap_margins
from mdgat_tpu.ops.transport import OTScores as JaxOTScores

from mdgat_tpu_torch.ops.cuda import gap_loss as G
from mdgat_tpu_torch.ops.losses import gap_loss
from mdgat_tpu_torch.ops.transport import OTScores

GAMMA = 0.5
# name -> (B, N, M, masked, what is special)
CASES = {
    "unmasked": (3, 20, 24, False, None),
    "masked": (3, 20, 24, True, None),
    "wide": (2, 17, 45, True, None),
    "tall": (2, 45, 17, True, None),
    "b1": (1, 12, 12, True, None),
    "b5": (5, 9, 14, False, None),
    "all_dustbin": (2, 10, 13, True, "all_dustbin"),
    "gt_out_of_range": (2, 10, 13, False, "gt_out_of_range"),
    "positive_in_masked_column": (2, 10, 13, True, "positive_masked"),
    "empty_cloud": (3, 10, 13, True, "empty_cloud"),
}


def _inputs(name, dtype):
    b, n, m, masked, special = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    dense = rng.normal(size=(b, n, m)).astype(dtype)
    binr = rng.normal(size=(b, m)).astype(dtype)
    binc = rng.normal(size=(b, n)).astype(dtype)
    gt0 = rng.integers(-1, m, (b, n)).astype(np.int32)
    gt1 = rng.integers(-1, n, (b, m)).astype(np.int32)
    rm = cm = None
    if masked:
        rm = np.arange(n)[None, :] < rng.integers(n // 2, n + 1, b)[:, None]
        cm = np.arange(m)[None, :] < rng.integers(m // 2, m + 1, b)[:, None]
    if special == "all_dustbin":
        gt0[:], gt1[:] = -1, -1
    elif special == "gt_out_of_range":
        # beyond the last candidate: matches no column, positive score 0;
        # below -1: the dustbin, like -1
        gt0[0, 0], gt0[0, 1], gt0[1, 2] = m + 3, m, -7
        gt1[0, 0], gt1[1, 1], gt1[1, 2] = n + 1, n, -2
    elif special == "positive_masked":
        cm[:, m - 1], rm[:, n - 1] = False, False
        gt0[:, 0], gt0[:, 1] = m - 1, m - 1     # the sentinel is the positive
        gt1[:, 0] = n - 1
    elif special == "empty_cloud":
        rm[1], cm[2] = False, False
        gt0[1], gt1[2] = -1, -1
    ds0 = rng.normal(size=(b, n)).astype(dtype)
    ds1 = rng.normal(size=(b, m)).astype(dtype)
    return dense, binr, binc, gt0, gt1, rm, cm, ds0, ds1


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _jmask(mask, shape):
    return jnp.ones(shape, bool) if mask is None else jnp.asarray(mask)


@pytest.mark.parametrize("name", list(CASES))
def test_margins_twin_matches_pallas_kernel_f32(name):
    """S0 / S1 of the forward twin against the Pallas kernel in interpret
    mode at float32, and the backward twin against ``jax.vjp`` of it at
    random cotangents: rtol 1e-5 / atol 1e-6, the JAX package's own
    tolerance for this kernel (f32 sums in another order). Sums that carry
    the -1e30 sentinel (a positive in a masked column) are compared
    relative."""
    dense, binr, binc, gt0, gt1, rm, cm, ds0, ds1 = _inputs(name, np.float32)
    b, n, m = dense.shape
    jargs = (jnp.asarray(dense), jnp.asarray(binr), jnp.asarray(binc),
             jnp.asarray(gt0), jnp.asarray(gt1), _jmask(rm, (b, n)),
             _jmask(cm, (b, m)))
    (w0, w1), vjp = jax.vjp(
        lambda d, r, c: jax_fused_gap_margins(GAMMA, True, d, r, c, *jargs[3:]),
        *jargs[:3])
    want_grads = vjp((jnp.asarray(ds0), jnp.asarray(ds1)))

    targs = tuple(_t(a) for a in (dense, binr, binc, gt0, gt1, rm, cm))
    s0, s1 = G.fused_gap_margins_reference(*targs, GAMMA)
    grads = G.fused_gap_margins_backward_reference(*targs, GAMMA, _t(ds0),
                                                   _t(ds1))
    assert s0.dtype == s1.dtype == torch.float32
    np.testing.assert_allclose(s0.numpy(), np.asarray(w0), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(s1.numpy(), np.asarray(w1), rtol=1e-5, atol=1e-6)
    for g, w in zip(grads, want_grads):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("name", list(CASES))
def test_gap_loss_kernel_matches_jax_gap_loss_f64(name):
    """``gap_loss_kernel`` (the autograd function over the twins, then the
    log1p and masked-mean epilogue) against the JAX package's XLA
    ``gap_loss`` at float64: the [B] loss and its gradients in dense,
    bin_row and bin_col to 1e-10. Finite on a cloud without a valid point."""
    dense, binr, binc, gt0, gt1, rm, cm, _, _ = _inputs(name, np.float64)
    b = dense.shape[0]
    corner = np.zeros(b)
    jgt0, jgt1 = jnp.asarray(gt0), jnp.asarray(gt1)
    jrm = None if rm is None else jnp.asarray(rm)
    jcm = None if cm is None else jnp.asarray(cm)

    def jloss(d, r, c):
        ot = JaxOTScores(d, r, c, jnp.asarray(corner))
        return jax_gap_loss(ot, jgt0, jgt1, GAMMA, jrm, jcm)

    jargs = (jnp.asarray(dense), jnp.asarray(binr), jnp.asarray(binc))
    want = np.asarray(jloss(*jargs))
    want_grads = jax.grad(lambda *a: jnp.sum(jloss(*a)), argnums=(0, 1, 2))(*jargs)

    leaves = [_t(a).requires_grad_() for a in (dense, binr, binc)]
    ot = OTScores(*leaves, _t(corner))
    # int64 ground truth, as the model hands it over
    loss = G.gap_loss_kernel(ot, _t(gt0).long(), _t(gt1).long(), GAMMA,
                             _t(rm), _t(cm))
    grads = torch.autograd.grad(loss.sum(), leaves)
    assert loss.shape == (b,) and loss.dtype == torch.float64
    assert np.isfinite(want).all()
    np.testing.assert_allclose(loss.detach().numpy(), want, rtol=1e-10,
                               atol=1e-10)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-10)


@pytest.mark.parametrize("name", list(CASES))
def test_backward_twin_matches_autograd_over_gap_loss_f64(name):
    """The backward twin's formulas through ``gap_loss_kernel`` against
    ``torch.autograd`` over the port's plain ``gap_loss``: 1e-12 at
    float64."""
    dense, binr, binc, gt0, gt1, rm, cm, _, _ = _inputs(name, np.float64)
    b = dense.shape[0]
    out = []
    for fn in (G.gap_loss_kernel, gap_loss):
        leaves = [_t(a).requires_grad_() for a in (dense, binr, binc)]
        ot = OTScores(*leaves, torch.zeros(b, dtype=torch.float64))
        loss = fn(ot, _t(gt0).long(), _t(gt1).long(), GAMMA, _t(rm), _t(cm))
        weights = torch.arange(1, b + 1, dtype=torch.float64)
        out.append((loss.detach(),
                    torch.autograd.grad((loss * weights).sum(), leaves)))
    (loss, grads), (loss_ref, grads_ref) = out
    np.testing.assert_allclose(loss.numpy(), loss_ref.numpy(), rtol=1e-12,
                               atol=1e-12)
    for g, w in zip(grads, grads_ref):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-12, atol=1e-12)


def test_counters_stand_still_on_the_cpu():
    dense, binr, binc, gt0, gt1, rm, cm, _, _ = _inputs("masked", np.float32)
    before = (G.fused_gap_margins.forward_launches,
              G.fused_gap_margins.backward_launches)
    leaves = [_t(a).requires_grad_() for a in (dense, binr, binc)]
    s0, s1 = G.fused_gap_margins(*leaves, _t(gt0), _t(gt1), _t(rm), _t(cm),
                                 GAMMA)
    (s0.sum() + s1.sum()).backward()
    assert all(leaf.grad is not None for leaf in leaves)
    assert before == (G.fused_gap_margins.forward_launches,
                      G.fused_gap_margins.backward_launches)


@pytest.mark.parametrize("fault", ["float64", "int64_gt", "not_contiguous",
                                   "too_wide", "bin_shape"])
def test_kernel_operand_check_raises(fault):
    """What the CUDA kernels cannot take raises; nothing takes the twin
    quietly. ``_check`` is what a CUDA call goes through before it
    launches (device placement is checked against ``dense``'s, so CPU
    tensors exercise it here)."""
    dense, binr, binc, gt0, gt1, rm, cm, _, _ = _inputs("masked", np.float32)
    args = [_t(a) for a in (dense, binr, binc, gt0, gt1, rm, cm)]
    G._check(*args)                                   # the good call passes
    if fault == "float64":
        args[0] = args[0].double()
    elif fault == "int64_gt":
        args[3] = args[3].long()
    elif fault == "not_contiguous":
        args[0] = args[0].transpose(1, 2).contiguous().transpose(1, 2)
    elif fault == "too_wide":
        args[0] = torch.zeros(1, 2, G.MAX_COLS + 1)
    elif fault == "bin_shape":
        args[1] = args[1][:, :-1]
    with pytest.raises(ValueError, match="gap-loss kernels"):
        G._check(*args)
