"""Port parity: the dustbin log-Sinkhorn (``mdgat_tpu_torch.ops.transport``,
the twin of the CUDA Sinkhorn kernel) against the JAX package's XLA
transport at float64 and its Pallas kernel in interpret mode at float32;
and the match decision against the JAX package's."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mdgat_tpu.ops.matching import match_decision as jax_decision
from mdgat_tpu.ops.pallas import pallas_log_optimal_transport
from mdgat_tpu.ops.pallas.sinkhorn import _prep as jax_prep
from mdgat_tpu.ops.transport import OTScores as JaxOT
from mdgat_tpu.ops.transport import log_optimal_transport as jax_ot

from mdgat_tpu_torch.ops.cuda import sinkhorn as kernel
from mdgat_tpu_torch.ops.matching import match_decision
from mdgat_tpu_torch.ops.transport import (OTScores, assemble_full_scores,
                                           log_optimal_transport)

B, N, M, ITERS = 3, 24, 40, 20


def _case(seed, dtype=np.float64, rows=(24, 17, 20), cols=(40, 29, 33)):
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(B, N, M)).astype(dtype)
    rm = np.arange(N)[None, :] < np.asarray(rows)[:, None]
    cm = np.arange(M)[None, :] < np.asarray(cols)[:, None]
    return scores, rm, cm


def _close(got: OTScores, ref, atol, rm=None, cm=None):
    dense, bin_row, bin_col = (got.dense.numpy(), got.bin_row.numpy(),
                               got.bin_col.numpy())
    rd, rbr, rbc = (np.asarray(ref.dense), np.asarray(ref.bin_row),
                    np.asarray(ref.bin_col))
    if rm is not None:  # compare the valid block; padding must stay sentinel
        vb = rm[:, :, None] & cm[:, None, :]
        assert (dense[~vb] < -1e29).all() and (rd[~vb] < -1e29).all()
        dense, rd = dense[vb], rd[vb]
        bin_row, rbr = bin_row[cm], rbr[cm]
        bin_col, rbc = bin_col[rm], rbc[rm]
    for a, b in ((dense, rd), (bin_row, rbr), (bin_col, rbc),
                 (got.corner.numpy(), np.asarray(ref.corner))):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)


@pytest.mark.parametrize("masked", [False, True])
def test_plain_transport_matches_xla_f64(masked):
    scores, rm, cm = _case(501)
    jm = (jnp.asarray(rm), jnp.asarray(cm)) if masked else (None, None)
    tmask = (torch.from_numpy(rm), torch.from_numpy(cm)) if masked \
        else (None, None)
    ref = jax_ot(jnp.asarray(scores), 0.7, ITERS, *jm)
    got = log_optimal_transport(torch.from_numpy(scores), 0.7, ITERS, *tmask)
    assert got.dense.dtype == torch.float64
    _close(got, ref, 1e-9, *((rm, cm) if masked else (None, None)))


@pytest.mark.parametrize("masked", [False, True])
def test_kernel_twin_matches_pallas_f32(masked):
    scores, rm, cm = _case(502, np.float32)
    jm = (jnp.asarray(rm), jnp.asarray(cm)) if masked else (None, None)
    ref = pallas_log_optimal_transport(jnp.asarray(scores), 1.0, ITERS, *jm,
                                       interpret=True)
    tmask = (torch.from_numpy(rm), torch.from_numpy(cm)) if masked \
        else (None, None)
    got = kernel.log_optimal_transport_kernel(torch.from_numpy(scores), 1.0,
                                              ITERS, *tmask)
    assert got.dense.dtype == torch.float32
    _close(got, ref, 1e-5, *((rm, cm) if masked else (None, None)))


def test_kernel_prep_matches_pallas_prep():
    """The plain prologue around the kernel: marginals and the per-pair
    scalar pack (alpha, log_mu_bin, log_nu_bin, norm)."""
    scores, rm, cm = _case(503, np.float32)
    j_scalars, _, j_mu, j_nu = jax_prep(jnp.asarray(scores), 0.3,
                                        jnp.asarray(rm), jnp.asarray(cm))
    t_scalars, t_mu, t_nu = kernel._prep(torch.from_numpy(scores), 0.3,
                                         torch.from_numpy(rm),
                                         torch.from_numpy(cm))
    np.testing.assert_allclose(t_scalars.numpy(), np.asarray(j_scalars)[:, 0],
                               rtol=1e-6)
    np.testing.assert_array_equal(t_mu.numpy(), np.asarray(j_mu)[:, :, 0])
    np.testing.assert_array_equal(t_nu.numpy(), np.asarray(j_nu)[:, 0, :])


def test_padded_equals_unpadded_on_the_valid_block():
    rng = np.random.default_rng(504)
    small = rng.normal(size=(1, 17, 29))
    padded = np.full((1, N, M), 7.0)
    padded[:, :17, :29] = small
    rm = np.arange(N)[None, :] < 17
    cm = np.arange(M)[None, :] < 29
    ref = log_optimal_transport(torch.from_numpy(small), 0.5, ITERS)
    got = log_optimal_transport(torch.from_numpy(padded), 0.5, ITERS,
                                torch.from_numpy(rm), torch.from_numpy(cm))
    np.testing.assert_allclose(got.dense[:, :17, :29].numpy(),
                               ref.dense.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.bin_row[:, :29].numpy(),
                               ref.bin_row.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.bin_col[:, :17].numpy(),
                               ref.bin_col.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.corner.numpy(), ref.corner.numpy(),
                               rtol=0, atol=1e-12)


def test_all_masked_column_and_example():
    """A column masked in every example, and an example whose rows are all
    masked: both packages agree, the dense block stays at the sentinel
    there, and nothing turns NaN."""
    scores, rm, cm = _case(505)
    cm[:, 5] = False
    rm[2, :] = False
    ref = jax_ot(jnp.asarray(scores), 0.5, ITERS, jnp.asarray(rm),
                 jnp.asarray(cm))
    got = log_optimal_transport(torch.from_numpy(scores), 0.5, ITERS,
                                torch.from_numpy(rm), torch.from_numpy(cm))
    assert not np.isnan(got.dense.numpy()).any()
    assert (got.dense.numpy()[:, :, 5] < -1e29).all()
    assert (got.dense.numpy()[2] < -1e29).all()
    _close(got, ref, 1e-9, rm, cm)
    full = assemble_full_scores(got)
    assert full.shape == (B, N + 1, M + 1)


def test_wrapper_dispatch_by_device():
    scores, rm, cm = _case(506, np.float32)
    args = (torch.from_numpy(scores), 1.0, 5, torch.from_numpy(rm),
            torch.from_numpy(cm))
    before = kernel.log_optimal_transport_kernel.launches
    got = kernel.log_optimal_transport_kernel(*args)
    ref = kernel.log_optimal_transport_reference(*args)
    assert torch.equal(got.dense, ref.dense)
    assert kernel.log_optimal_transport_kernel.launches == before
    with pytest.raises(ValueError, match="no Sinkhorn kernel"):
        kernel.log_optimal_transport_kernel(args[0].to("meta"), 1.0, 5)


@pytest.mark.parametrize("loss_method", ["gap_loss", "superglue"])
@pytest.mark.parametrize("mutual", [False, True])
def test_match_decision_matches_jax(loss_method, mutual):
    """Both rules and their mutual variants, first-max ties (a whole-row
    and a whole-column tie), dense-vs-dustbin ties, masks, the batch-global
    zero-score quirk (second call: no valid match anywhere)."""
    scores, rm, cm = _case(507)
    ot = log_optimal_transport(torch.from_numpy(scores), 0.5, ITERS,
                               torch.from_numpy(rm), torch.from_numpy(cm))
    dense = ot.dense.numpy().copy()
    dense[0, 3, :] = dense[0, 3, 5]
    dense[1, :, 7] = dense[1, 2, 7]
    bin_col = ot.bin_col.numpy().copy()
    bin_col[0, 4] = dense[0, 4].max()
    cases = [(dense, ot.bin_row.numpy(), bin_col, ot.corner.numpy()),
             (dense - 1e3, ot.bin_row.numpy(), bin_col, ot.corner.numpy())]
    for d, br, bc, c in cases:
        got = match_decision(OTScores(*map(torch.from_numpy, (d, br, bc, c))),
                             loss_method, 0.2, mutual, torch.from_numpy(rm),
                             torch.from_numpy(cm))
        ref = jax_decision(JaxOT(*map(jnp.asarray, (d, br, bc, c))),
                           loss_method, 0.2, mutual, jnp.asarray(rm),
                           jnp.asarray(cm))
        for i in (0, 1):          # matches: identical
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref[i]))
        for i in (2, 3):          # scores: exp() may differ in the last ulp
            np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]),
                                       rtol=1e-12, atol=0)
        assert (got.matches0.numpy()[~rm] == -1).all()
        assert (got.matches1.numpy()[~cm] == -1).all()
