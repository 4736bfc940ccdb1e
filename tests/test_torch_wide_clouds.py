"""Port parity at clouds of more than 1024 keypoints, the shapes that the
port's wide kernel arms take on the card (attention, attention backward,
Sinkhorn forward and backward, gap loss): the port's plain path, which its
wrappers take on CPU tensors, against the JAX package on the same numpy
inputs, at N, M in {1025, 1300}, float64 (``tests/conftest.py``),
tolerance 1e-9 absolute. The JAX side runs the route it takes at these
shapes on the CPU: the XLA model forward, the trainable Pallas transport's
entry (whose VMEM gate steps down to the XLA scan here) and the XLA gap
loss, each under ``jax.grad`` where a gradient is compared. The kernels
themselves are held against these twins on the card by ``chip_smoke.py``
(its wide-clouds phase).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mdgat_tpu.core.config import test_defaults as jax_test_defaults
from mdgat_tpu.models import MDGAT as JaxMDGAT
from mdgat_tpu.ops import losses as jax_losses
from mdgat_tpu.ops.pallas import pallas_log_optimal_transport_trainable
from mdgat_tpu.ops.transport import OTScores as JaxOTScores

from mdgat_tpu_torch.core.checkpoint import state_dict_from_numpy
from mdgat_tpu_torch.core.config import test_defaults as port_defaults
from mdgat_tpu_torch.models.mdgat import MDGAT
from mdgat_tpu_torch.ops import losses as port_losses
from mdgat_tpu_torch.ops.cuda.gap_loss import gap_loss_kernel
from mdgat_tpu_torch.ops.cuda.sinkhorn import log_optimal_transport_kernel
from mdgat_tpu_torch.ops.transport import OTScores

SMALL = dict(L=2, k=(8, None), descriptor_dim=32, num_heads=2,
             keypoint_encoder=(16, 32), descriptor_encoder=(16,),
             sinkhorn_iterations=5, compute_dtype="float64",
             param_dtype="float64")
TOL = dict(rtol=0, atol=1e-9)
SIZES = [1025, 1300]


@pytest.fixture(scope="module")
def weights():
    params, state = JaxMDGAT(jax_test_defaults(**SMALL)).init(
        jax.random.PRNGKey(11))
    params = jax.tree.map(np.asarray, params)
    params["bin_score"] = np.asarray(0.4)
    return params, jax.tree.map(np.asarray, state)


def _clouds(seed, size):
    """Two pairs of ``size`` x ``size + 7`` padded keypoints with ragged
    valid counts (one cloud full), the second cloud a moved, noisy copy
    of most of the first."""
    rng = np.random.default_rng(seed)
    b, n, m = 2, size, size + 7
    counts0, counts1 = (n, n - 37), (m - 11, m)
    kp0 = rng.uniform(-20, 20, (b, n, 3))
    desc0 = np.abs(rng.normal(size=(b, n, 33)))
    kp1 = rng.uniform(-20, 20, (b, m, 3))
    desc1 = np.abs(rng.normal(size=(b, m, 33)))
    shared = n // 2
    kp1[:, :shared] = kp0[:, :shared] + 0.05 * rng.normal(size=(b, shared, 3))
    desc1[:, :shared] = desc0[:, :shared] + 0.01 * rng.normal(size=(b, shared, 33))
    return {"keypoints0": kp0, "keypoints1": kp1,
            "descriptors0": desc0, "descriptors1": np.abs(desc1),
            "scores0": rng.uniform(10, 30, (b, n)),
            "scores1": rng.uniform(10, 30, (b, m)),
            "mask0": np.arange(n)[None, :] < np.asarray(counts0)[:, None],
            "mask1": np.arange(m)[None, :] < np.asarray(counts1)[:, None]}


@pytest.mark.parametrize("size", SIZES)
def test_eval_forward_matches_jax_f64(weights, size):
    """The MDGAT eval forward (top-k attention over more than 1024 keys,
    the transport): the full [B, N+1, M+1] scores on every valid entry and
    the matches both ways."""
    params, state = weights
    data = _clouds(700 + size, size)
    ref, _ = JaxMDGAT(jax_test_defaults(**SMALL)).apply(
        params, state, {k: jnp.asarray(v) for k, v in data.items()},
        train=False, return_full_scores=True)
    cfg = port_defaults(**SMALL)
    model = MDGAT(cfg)
    model.load_state_dict(state_dict_from_numpy(params, state, cfg), strict=True)
    with torch.no_grad():
        got = model.eval()({k: torch.from_numpy(v) for k, v in data.items()},
                           return_full_scores=True)
    b, n, m = 2, size, size + 7
    scores, want = got["scores"].numpy(), np.asarray(ref["scores"])
    assert scores.shape == want.shape == (b, n + 1, m + 1)
    rows = np.concatenate([data["mask0"], np.ones((b, 1), bool)], axis=1)
    cols = np.concatenate([data["mask1"], np.ones((b, 1), bool)], axis=1)
    valid = rows[:, :, None] & cols[:, None, :]
    np.testing.assert_allclose(scores[valid], want[valid], **TOL)
    for key in ("matches0", "matches1"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]))
    assert (got["matches0"].numpy() >= 0).sum() > 0


def _weighted(ot, cot, xp):
    return sum(xp.sum(getattr(ot, k) * cot[k]) for k in cot)


@pytest.mark.parametrize("n, m", [(1025, 1300), (1300, 1025)])
def test_trainable_sinkhorn_matches_jax_f64(n, m):
    """The trainable transport's entry: the four outputs on the valid
    block and the gradients of a weighted sum of them with respect to the
    scores and alpha, masked and ragged, 5 iterations."""
    rng = np.random.default_rng(710 + n)
    b, iters, alpha = 2, 5, 0.9
    scores = rng.normal(size=(b, n, m))
    rm = np.arange(n)[None, :] < np.array([[n], [n - 100]])
    cm = np.arange(m)[None, :] < np.array([[m - 50], [m]])
    valid = rm[:, :, None] & cm[:, None, :]
    cot = dict(dense=rng.normal(size=(b, n, m)) * valid,
               bin_row=rng.normal(size=(b, m)) * cm,
               bin_col=rng.normal(size=(b, n)) * rm,
               corner=rng.normal(size=(b,)))
    s = torch.from_numpy(scores).requires_grad_()
    a = torch.tensor(alpha, dtype=torch.float64, requires_grad=True)
    ot = log_optimal_transport_kernel(s, a, iters, torch.from_numpy(rm),
                                      torch.from_numpy(cm))
    _weighted(ot, {k: torch.from_numpy(v) for k, v in cot.items()},
              torch).backward()

    def loss(sc, al):
        out = pallas_log_optimal_transport_trainable(
            sc, al, iters, jnp.asarray(rm), jnp.asarray(cm), interpret=True)
        return _weighted(out, {k: jnp.asarray(v) for k, v in cot.items()},
                         jnp), out

    (_, ref), (ds, da) = jax.value_and_grad(loss, (0, 1), has_aux=True)(
        jnp.asarray(scores), jnp.asarray(alpha))
    np.testing.assert_allclose(ot.dense.detach().numpy()[valid],
                               np.asarray(ref.dense)[valid], **TOL)
    np.testing.assert_allclose(ot.bin_row.detach().numpy()[cm],
                               np.asarray(ref.bin_row)[cm], **TOL)
    np.testing.assert_allclose(ot.bin_col.detach().numpy()[rm],
                               np.asarray(ref.bin_col)[rm], **TOL)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(ds), **TOL)
    np.testing.assert_allclose(a.grad.item(), float(da), **TOL)
    assert not s.grad.numpy()[~valid].any()


@pytest.mark.parametrize("n, m", [(1025, 1300), (1300, 1025)])
@pytest.mark.parametrize("entry", ["gap_loss_kernel", "gap_loss"])
def test_gap_loss_and_gradient_match_jax_f64(n, m, entry):
    """The gap loss [B] and its gradients with respect to the dense block,
    the bin row and the bin column, masked and ragged, with dustbin anchors:
    the kernels' entry (its formula twins on the CPU) and the plain loss,
    each against the JAX package's XLA ``gap_loss`` under ``jax.grad``."""
    rng = np.random.default_rng(720 + n)
    b, gamma = 2, 0.5
    rm = np.arange(n)[None, :] < np.array([[n], [n - 60]])
    cm = np.arange(m)[None, :] < np.array([[m - 30], [m]])
    dense = rng.normal(size=(b, n, m)) - 3.0
    bin_row, bin_col = rng.normal(size=(b, m)) - 2.0, rng.normal(size=(b, n)) - 2.0
    gt0 = np.full((b, n), -1, np.int64)
    gt1 = np.full((b, m), -1, np.int64)
    for i in range(b):
        k = int(min(rm[i].sum(), cm[i].sum())) // 2
        rows = rng.permutation(int(rm[i].sum()))[:k]
        cols = rng.permutation(int(cm[i].sum()))[:k]
        gt0[i, rows], gt1[i, cols] = cols, rows
    w = rng.uniform(0.5, 1.5, b)

    leaves = [torch.from_numpy(x).requires_grad_() for x in (dense, bin_row, bin_col)]
    fn = gap_loss_kernel if entry == "gap_loss_kernel" else port_losses.gap_loss
    got = fn(OTScores(*leaves, torch.zeros(b, dtype=torch.float64)),
             torch.from_numpy(gt0), torch.from_numpy(gt1), gamma,
             torch.from_numpy(rm), torch.from_numpy(cm))
    (got * torch.from_numpy(w)).sum().backward()

    def loss(d, br, bc):
        per = jax_losses.gap_loss(
            JaxOTScores(d, br, bc, jnp.zeros(b)), jnp.asarray(gt0),
            jnp.asarray(gt1), gamma, jnp.asarray(rm), jnp.asarray(cm))
        return jnp.sum(per * jnp.asarray(w)), per

    (_, want), grads = jax.value_and_grad(loss, (0, 1, 2), has_aux=True)(
        jnp.asarray(dense), jnp.asarray(bin_row), jnp.asarray(bin_col))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for leaf, g in zip(leaves, grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g), **TOL)
