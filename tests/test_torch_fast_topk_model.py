"""Port parity of the fast top-k arm (the attention kernel's value
bisection, the JAX package's default selection) for the slice as a whole,
and of its switch: the port's eval forward and one train step with the
kernel routes' twins on the CPU (``Config.kernel_twins``, the counterpart of
the JAX package's ``pallas_interpret``) and the fast arm against the JAX
model with its Pallas kernels in interpret mode and
``pallas_exact_topk=False``; a CPU ``Matcher`` selects the exact top-k
whatever ``exact_topk`` says, as the JAX package's XLA path does. The
module-level checks are in ``tests/test_torch_fast_topk.py``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mdgat_tpu.core.config import test_defaults as jax_test_defaults
from mdgat_tpu.models import MDGAT as JaxMDGAT

from mdgat_tpu_torch import Matcher
from mdgat_tpu_torch.core.checkpoint import state_dict_from_numpy
from mdgat_tpu_torch.core.config import test_defaults as port_test_defaults
from mdgat_tpu_torch.models.mdgat import MDGAT

# ---------------------------------------------------------------------------

TINY = dict(L=2, k=(8, None), descriptor_dim=32, keypoint_encoder=(16, 32),
            descriptor_encoder=(16,), sinkhorn_iterations=20,
            compute_dtype="float32", param_dtype="float32")


def _model_weights():
    cfg = jax_test_defaults(**TINY)
    params, state = JaxMDGAT(cfg).init(jax.random.PRNGKey(4))
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)


def _model_batch(seed):
    from mdgat_tpu.data.synthetic import make_synthetic_pair
    rng = np.random.default_rng(seed)
    pairs = [make_synthetic_pair(rng, n_points=40, overlap=0.8, jitter=0.02,
                                 desc_noise=0.02) for _ in range(2)]
    data = {}
    for side in ("0", "1"):
        data["keypoints" + side] = np.stack([p["kp" + side] for p in pairs])
        data["descriptors" + side] = np.stack([p["desc" + side] for p in pairs])
        data["scores" + side] = np.full((2, 40), 20.0)
        mask = np.ones((2, 40), bool)
        mask[1, 33:] = False
        data["mask" + side] = mask
    return {k: (v.astype(np.float32) if v.dtype == np.float64 else v)
            for k, v in data.items()}


def test_forward_matches_pallas_model_fast_topk():
    """The port's forward with the kernel routes' twins on the CPU
    (``kernel_twins``) and the fast arm against ``MDGAT.apply`` with the
    Pallas kernels in interpret mode and ``pallas_exact_topk=False``:
    identical matches, scores to 1e-4."""
    params, state = _model_weights()
    data = _model_batch(8)
    jcfg = jax_test_defaults(**TINY, pallas_interpret=True,
                             pallas_exact_topk=False)
    ref, _ = JaxMDGAT(jcfg).apply(params, state,
                                  {k: jnp.asarray(v) for k, v in data.items()},
                                  train=False)
    cfg = port_test_defaults(**TINY, kernel_twins=True)
    model = MDGAT(cfg)
    model.load_state_dict(state_dict_from_numpy(params, state, cfg),
                          strict=True)
    with torch.no_grad():
        got = {k: v.numpy() for k, v in model.eval()(
            {k: torch.from_numpy(v) for k, v in data.items()}).items()}
    for key in ("matches0", "matches1"):
        np.testing.assert_array_equal(got[key], np.asarray(ref[key]))
    for key in ("matching_scores0", "matching_scores1"):
        np.testing.assert_allclose(got[key], np.asarray(ref[key]), rtol=0,
                                   atol=1e-4)


def test_train_step_matches_jax_default_routing_fast_topk():
    """One train step of the JAX package at its default routing (whole-layer
    train kernels, interpret mode, ``pallas_exact_topk=False``) against the
    port's default route on the CPU with ``kernel_twins``: loss and
    grad_norm to 5e-5 relative, every gradient to 2e-6, the tolerances of
    the exact arm's test (``tests/test_torch_train_step.py``)."""
    from test_torch_train_step import _compare, _run_both
    got, want = _run_both("gap_loss", "float32", 1, over=dict(L=1),
                          port_flags=dict(train_layer=True, kernel_twins=True,
                                          exact_topk=False),
                          pallas_interpret=True, pallas_exact_topk=False,
                          pallas_train_layer=True)
    _compare(got, want, metric_rtol=5e-5, grad_atol=2e-6, param_atol=1e-5,
             noise_atol=2.1e-3, mean_atol=0.2 * 2.1e-3, stat_atol=1e-5,
             var_rtol=1e-5)


def test_cpu_matcher_is_exact_whatever_the_switch_says():
    """The plain route and the CPU select the exact top-k, as the JAX
    package's XLA path does: a CPU ``Matcher`` gives the same matches with
    either value of ``exact_topk``."""
    rng = np.random.default_rng(3)
    kp0, kp1 = rng.uniform(-5, 5, (60, 3)), rng.uniform(-5, 5, (50, 3))
    d0, d1 = np.abs(rng.normal(size=(60, 33))), np.abs(rng.normal(size=(50, 33)))
    small = dict(L=2, k=(8, None), descriptor_dim=32,
                 keypoint_encoder=(16, 32), descriptor_encoder=(16,))
    outs = [Matcher(seed=1, device="cpu", exact_topk=flag, **small)
            .match(kp0, d0, kp1, d1) for flag in (False, True)]
    assert outs[0]["matches0"].shape == (60,)
    for key in ("matches0", "matches1", "matching_scores0",
                "matching_scores1"):
        np.testing.assert_array_equal(outs[0][key], outs[1][key])
    assert Matcher(seed=1, device="cpu", **small).cfg.exact_topk is False


@pytest.mark.parametrize("preset", ["train", "test"])
def test_pallas_exact_topk_flag_reaches_the_config(preset):
    """``--pallas_exact_topk`` keeps the JAX parser's name, type and default
    (false) and lands in ``Config.exact_topk`` as the JAX package's lands
    in ``pallas_exact_topk``."""
    from mdgat_tpu import cli as jax_cli
    from mdgat_tpu_torch import cli
    for argv, want in (([], False), (["--pallas_exact_topk", "true"], True)):
        args = cli.build_parser(preset).parse_args(argv)
        jargs = jax_cli.build_parser(preset).parse_args(argv)
        assert args.pallas_exact_topk is jargs.pallas_exact_topk is want
        assert cli.config_from_args(args, preset).exact_topk is want
        assert jax_cli.config_from_args(jargs, preset).pallas_exact_topk is want
    assert "--pallas_exact_topk" not in cli.build_parser(preset).epilog
