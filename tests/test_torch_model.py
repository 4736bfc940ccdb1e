"""Port parity of the whole serving slice: ``mdgat_tpu_torch.Matcher`` and
``MDGAT`` against ``mdgat_tpu.api.Matcher`` / ``MDGAT.apply`` on the same
numpy weights (bridged with ``state_dict_from_numpy``), on masked batches
with unequal keypoint counts per cloud."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mdgat_tpu.api import Matcher as JaxMatcher
from mdgat_tpu.core.config import test_defaults as jax_test_defaults
from mdgat_tpu.data.synthetic import make_synthetic_pair
from mdgat_tpu.models import MDGAT as JaxMDGAT

from mdgat_tpu_torch import Matcher
from mdgat_tpu_torch.core.checkpoint import state_dict_from_numpy
from mdgat_tpu_torch.core.config import test_defaults as port_defaults
from mdgat_tpu_torch.models.mdgat import MDGAT

TINY = dict(L=2, k=(8, None), descriptor_dim=32, keypoint_encoder=(16, 32),
            descriptor_encoder=(16,), sinkhorn_iterations=20,
            compute_dtype="float64", param_dtype="float64")


@pytest.fixture(scope="module")
def weights():
    """JAX-initialised trees as numpy, with random BN running stats and
    affines everywhere and a non-default bin score."""
    cfg = jax_test_defaults(**TINY)
    params, state = JaxMDGAT(cfg).init(jax.random.PRNGKey(4))
    params = jax.tree.map(np.asarray, params)
    state = jax.tree.map(np.asarray, state)
    rng = np.random.default_rng(600)

    def randomise(p_layers, s_layers):
        for p, s in zip(p_layers, s_layers):
            if "bn" in p:
                c = p["bn"]["scale"].shape[0]
                p["bn"] = {"scale": rng.uniform(0.5, 1.5, c),
                           "bias": rng.normal(size=c) * 0.2}
                s.update(mean=rng.normal(size=c) * 0.3,
                         var=rng.uniform(0.5, 1.5, c))

    randomise(params["kenc"]["mlp"], state["kenc"]["mlp"])
    randomise(params["denc"]["mlp"], state["denc"]["mlp"])
    for p, s in zip(params["gnn"], state["gnn"]):
        randomise(p["mlp"], s["mlp"])
    params["bin_score"] = np.asarray(0.6)
    return params, state


def _pairs(seed, sizes):
    rng = np.random.default_rng(seed)
    out = []
    for n0, n1 in sizes:
        p = make_synthetic_pair(rng, n_points=max(n0, n1), overlap=0.8,
                                jitter=0.02, desc_noise=0.02)
        out.append(dict(kp0=p["kp0"][:n0], desc0=p["desc0"][:n0],
                        score0=p["score0"][:n0], kp1=p["kp1"][:n1],
                        desc1=p["desc1"][:n1], score1=p["score1"][:n1]))
    return out


SIZES = [(40, 52), (64, 24), (31, 47)]


def test_match_and_register_batch_match_jax_matcher_f64(weights):
    params, state = weights
    ref = JaxMatcher(params=params, bn_state=state, **TINY)
    port = Matcher(params=params, bn_state=state, device="cpu", **TINY)
    pairs = _pairs(601, SIZES)
    got, want = port.match_batch(pairs), ref.match_batch(pairs)
    n_matches = 0
    for g, w in zip(got, want):
        for key in ("matches0", "matches1"):
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
        for key in ("matching_scores0", "matching_scores1"):
            assert g[key].dtype == np.float32
            np.testing.assert_allclose(g[key], w[key], rtol=0, atol=1e-9)
        n_matches += int((g["matches0"] >= 0).sum())
    assert n_matches > 0          # the comparison covers real matches

    got_r = port.register_batch(pairs, min_matches=3)
    want_r = ref.register_batch(pairs, min_matches=3)
    assert any(g["T"] is not None for g in got_r)
    for g, w in zip(got_r, want_r):
        assert g["n_matches"] == w["n_matches"]
        assert g["inliers"] == w["inliers"]
        if w["T"] is None:
            assert g["T"] is None
        else:
            np.testing.assert_allclose(g["T"], w["T"], rtol=0, atol=1e-8)


def _batch(seed, b=3, n=40, m=48, counts0=(40, 33, 25), counts1=(48, 30, 41)):
    rng = np.random.default_rng(seed)
    data = {
        "keypoints0": rng.uniform(-20, 20, (b, n, 3)),
        "keypoints1": rng.uniform(-20, 20, (b, m, 3)),
        "descriptors0": np.abs(rng.normal(size=(b, n, 33))),
        "descriptors1": np.abs(rng.normal(size=(b, m, 33))),
        "scores0": rng.uniform(10, 30, (b, n)),
        "scores1": rng.uniform(10, 30, (b, m)),
        "mask0": np.arange(n)[None, :] < np.asarray(counts0)[:, None],
        "mask1": np.arange(m)[None, :] < np.asarray(counts1)[:, None],
    }
    data["descriptors1"][:, :20] = data["descriptors0"][:, :20] + \
        0.01 * rng.normal(size=(b, 20, 33))
    gt0 = np.full((b, n), -1, np.int64)
    gt1 = np.full((b, m), -1, np.int64)
    for i in range(b):
        k = min(counts0[i], counts1[i]) // 2
        rows = rng.permutation(counts0[i])[:k]
        cols = rng.permutation(counts1[i])[:k]
        gt0[i, rows], gt1[i, cols] = cols, rows
    return data, gt0, gt1


def _port_model(params, state, **overrides):
    cfg = port_defaults(**{**TINY, **overrides})
    model = MDGAT(cfg)
    model.load_state_dict(state_dict_from_numpy(params, state, cfg),
                          strict=True)
    return model.eval()


def _run_port(model, data, gt=None):
    batch = {k: torch.from_numpy(v) for k, v in data.items()}
    if gt is not None:
        batch["gt_matches0"], batch["gt_matches1"] = map(torch.from_numpy, gt)
    with torch.no_grad():
        return {k: v.numpy() for k, v in model(batch).items()}


def test_forward_matches_pallas_model_exact_topk(weights):
    """The port's float32 CPU forward against ``MDGAT.apply`` with the
    whole-layer and Sinkhorn Pallas kernels in interpret mode and exact
    top-k selection: identical matches, scores to 1e-4."""
    params, state = weights
    data, _, _ = _batch(602)
    over = dict(compute_dtype="float32")
    jcfg = jax_test_defaults(**{**TINY, **over}, pallas_interpret=True,
                             pallas_exact_topk=True)
    ref, _ = JaxMDGAT(jcfg).apply(params, state,
                                  {k: jnp.asarray(v) for k, v in data.items()},
                                  train=False)
    got = _run_port(_port_model(params, state, **over), data)
    for key in ("matches0", "matches1"):
        np.testing.assert_array_equal(got[key], np.asarray(ref[key]))
    for key in ("matching_scores0", "matching_scores1"):
        np.testing.assert_allclose(got[key], np.asarray(ref[key]), rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("loss_method",
                         ["gap_loss", "triplet_loss", "superglue"])
def test_forward_with_ground_truth_matches_jax_f64(weights, loss_method):
    params, state = weights
    data, gt0, gt1 = _batch(603)
    jcfg = jax_test_defaults(**TINY, loss_method=loss_method)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    jdata["gt_matches0"], jdata["gt_matches1"] = jnp.asarray(gt0), jnp.asarray(gt1)
    ref, _ = JaxMDGAT(jcfg).apply(params, state, jdata, train=False)
    got = _run_port(_port_model(params, state, loss_method=loss_method),
                    data, (gt0, gt1))
    assert got["loss"].shape == (3,)
    np.testing.assert_allclose(got["loss"], np.asarray(ref["loss"]), rtol=0,
                               atol=1e-9)
    for key in ("matches0", "matches1"):
        np.testing.assert_array_equal(got[key], np.asarray(ref[key]))
    for key in ("matching_scores0", "matching_scores1"):
        np.testing.assert_allclose(got[key], np.asarray(ref[key]), rtol=0,
                                   atol=1e-9)


@pytest.mark.parametrize("use_kernels", [True, False],
                         ids=["use_kernels", "no_kernels"])
def test_loss_kernel_in_eval_mode_matches_jax_f64(weights, use_kernels):
    """``loss_kernel=True`` routes the gap loss through the margin kernels'
    entry in eval mode too, and whatever ``use_kernels`` says (as
    ``pallas_loss`` in the JAX package): the same [B] loss as the JAX
    package's XLA ``gap_loss``."""
    params, state = weights
    data, gt0, gt1 = _batch(605)
    jcfg = jax_test_defaults(**TINY, loss_method="gap_loss")
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    jdata["gt_matches0"], jdata["gt_matches1"] = jnp.asarray(gt0), jnp.asarray(gt1)
    ref, _ = JaxMDGAT(jcfg).apply(params, state, jdata, train=False)
    model = _port_model(params, state, loss_method="gap_loss",
                        loss_kernel=True, use_kernels=use_kernels)
    assert model.config.loss_kernel and not model.training
    got = _run_port(model, data, (gt0, gt1))
    np.testing.assert_allclose(got["loss"], np.asarray(ref["loss"]), rtol=0,
                               atol=1e-9)


def test_use_kernels_on_cpu_runs_the_plain_path(weights):
    params, state = weights
    data, _, _ = _batch(604)
    a = _run_port(_port_model(params, state), data)
    b = _run_port(_port_model(params, state, use_kernels=False), data)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])


def test_cuda_matcher_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Matcher(seed=0, device="cuda", **TINY)


def test_matcher_needs_weights_and_seeded_init_is_deterministic():
    with pytest.raises(ValueError, match="seed"):
        Matcher(device="cpu", **TINY)
    pairs = _pairs(605, [(30, 35)])
    a = Matcher(seed=3, device="cpu", **TINY).match_batch(pairs)[0]
    b = Matcher(seed=3, device="cpu", **TINY).match_batch(pairs)[0]
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])
    sd0 = Matcher(seed=3, device="cpu", **TINY).model.state_dict()
    sd1 = Matcher(seed=4, device="cpu", **TINY).model.state_dict()
    assert not torch.equal(sd0["gnn.layers.0.attn.proj.0.weight"],
                           sd1["gnn.layers.0.attn.proj.0.weight"])
    # the reference zero-initialises the last conv bias of each encoder
    # and each GNN MLP
    assert not sd0["kenc.encoder.6.bias"].any()
    assert not sd0["denc.encoder.3.bias"].any()
    assert not sd0["gnn.layers.1.mlp.3.bias"].any()
    assert sd0["gnn.layers.1.mlp.0.bias"].any()
    assert sd0["bin_score"].item() == 1.0


def test_match_batch_equals_per_pair_match():
    m = Matcher(seed=1, device="cpu", **TINY)
    pairs = _pairs(606, [(40, 30), (150, 60)])
    batched = m.match_batch(pairs)
    assert m.match_batch([]) == []
    for p, got in zip(pairs, batched):
        one = m.match(**p)
        for key in one:
            np.testing.assert_allclose(got[key], one[key], rtol=0, atol=1e-12)
