"""Port parity of the three matching losses with their gradients
(``mdgat_tpu_torch.ops.losses``) against ``mdgat_tpu.ops.losses`` under
``jax.grad``: per-example ``[B]`` values and the gradients with respect to
the dense block, the bin row and the bin column, on masked batches with
unequal counts; the ground truth is never mutated. float64, tolerance
1e-9.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mdgat_tpu.ops import losses as jl
from mdgat_tpu.ops.transport import OTScores as JaxOT

from mdgat_tpu_torch.ops import losses as pl
from mdgat_tpu_torch.ops.transport import OTScores

TOL = dict(rtol=0, atol=1e-9)


def _case(seed, masked, b=4, n=14, m=18):
    rng = np.random.default_rng(seed)
    c0 = np.array([14, 9, 12, 5]) if masked else np.full(b, n)
    c1 = np.array([18, 18, 7, 11]) if masked else np.full(b, m)
    rm = np.arange(n)[None, :] < c0[:, None]
    cm = np.arange(m)[None, :] < c1[:, None]
    ot = dict(dense=rng.normal(size=(b, n, m)) - 3.0,
              bin_row=rng.normal(size=(b, m)) - 2.0,
              bin_col=rng.normal(size=(b, n)) - 2.0,
              corner=rng.normal(size=(b,)))
    gt0 = np.full((b, n), -1, np.int64)
    gt1 = np.full((b, m), -1, np.int64)
    for i in range(b):
        k = min(c0[i], c1[i]) // 2
        rows, cols = rng.permutation(c0[i])[:k], rng.permutation(c1[i])[:k]
        gt0[i, rows], gt1[i, cols] = cols, rows
    w = rng.uniform(0.5, 1.5, b)          # weights of the per-example vector
    return ot, gt0, gt1, (rm, cm) if masked else (None, None), w


def _call(mod, name, ot, gt0, gt1, rm, cm):
    if name == "superglue":
        return mod.superglue_nll_loss(ot, gt0, gt1, rm, cm)
    return getattr(mod, name)(ot, gt0, gt1, 0.5, rm, cm)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("name", ["gap_loss", "triplet_loss", "superglue"])
def test_loss_values_and_gradients_match_jax_grad(name, masked):
    ot, gt0, gt1, (rm, cm), w = _case(41 + masked, masked)
    jmask = [None if x is None else jnp.asarray(x) for x in (rm, cm)]

    def jloss(dense, bin_row, bin_col):
        o = JaxOT(dense, bin_row, bin_col, jnp.asarray(ot["corner"]))
        return _call(jl, name, o, jnp.asarray(gt0), jnp.asarray(gt1), *jmask)

    args = [jnp.asarray(ot[k]) for k in ("dense", "bin_row", "bin_col")]
    want = np.asarray(jloss(*args))
    want_g = jax.grad(lambda *a: jnp.sum(jloss(*a) * w), (0, 1, 2))(*args)

    t = {k: torch.from_numpy(v).requires_grad_() for k, v in ot.items()}
    g0, g1 = torch.from_numpy(gt0), torch.from_numpy(gt1)
    g0_before, g1_before = g0.clone(), g1.clone()
    tmask = [None if x is None else torch.from_numpy(x) for x in (rm, cm)]
    got = _call(pl, name, OTScores(**t), g0, g1, *tmask)
    assert got.shape == (4,)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    (got * torch.from_numpy(w)).sum().backward()
    for key, wg in zip(("dense", "bin_row", "bin_col"), want_g):
        grad = t[key].grad
        grad = np.zeros_like(ot[key]) if grad is None else grad.numpy()
        np.testing.assert_allclose(grad, np.asarray(wg), err_msg=key, **TOL)
    assert np.abs(np.asarray(want_g[0])).sum() > 0
    assert torch.equal(g0, g0_before) and torch.equal(g1, g1_before)
