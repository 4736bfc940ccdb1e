"""The port's weights bridge and package hygiene: JAX trees, native
``.npz`` and reference ``.pth`` checkpoints load into the port with
``strict=True`` and the upstream key names, and importing the port pulls
in neither JAX nor the JAX package."""

import os
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch

from mdgat_tpu.core.checkpoint import (export_pth_state_dict, load_checkpoint,
                                       save_checkpoint, save_pth_checkpoint)
from mdgat_tpu.core.config import test_defaults as jax_test_defaults
from mdgat_tpu.models import MDGAT as JaxMDGAT

from mdgat_tpu_torch import Matcher
from mdgat_tpu_torch.core.checkpoint import (load_npz, load_pth_state_dict,
                                             state_dict_from_numpy)
from mdgat_tpu_torch.core.config import test_defaults as port_defaults
from mdgat_tpu_torch.models.mdgat import MDGAT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(L=2, k=(8, None), descriptor_dim=32, keypoint_encoder=(16, 32),
            descriptor_encoder=(16,), sinkhorn_iterations=10,
            compute_dtype="float64", param_dtype="float64")


@pytest.fixture(scope="module")
def trees():
    params, state = JaxMDGAT(jax_test_defaults(**TINY)).init(
        jax.random.PRNGKey(9))
    params = jax.tree.map(np.asarray, params)
    state = jax.tree.map(np.asarray, state)
    rng = np.random.default_rng(700)
    st = state["gnn"][1]["mlp"][0]
    st["mean"], st["var"] = rng.normal(size=64), rng.uniform(0.5, 2, 64)
    return params, state


def test_state_dict_equals_jax_export(trees):
    params, state = trees
    cfg = port_defaults(**TINY)
    got = state_dict_from_numpy(params, state, cfg)
    want = export_pth_state_dict(params, state, jax_test_defaults(**TINY),
                                 dtype=np.float64, module_prefix=False)
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        assert got[key].dtype == torch.from_numpy(np.array(val)).dtype, key
        np.testing.assert_array_equal(got[key].numpy(), val, err_msg=key)
    # and it is exactly the port model's state-dict layout
    model = MDGAT(cfg)
    assert sorted(model.state_dict()) == sorted(got)
    model.load_state_dict(got, strict=True)


def _pair(seed):
    rng = np.random.default_rng(seed)
    return dict(kp0=rng.normal(size=(30, 3)) * 10,
                desc0=np.abs(rng.normal(size=(30, 33))),
                kp1=rng.normal(size=(37, 3)) * 10,
                desc1=np.abs(rng.normal(size=(37, 33))))


def test_npz_checkpoint_loads_strict(trees, tmp_path):
    params, state = trees
    path = str(tmp_path / "model.npz")
    save_checkpoint(path, params, state, epoch=3, lr=1e-4, loss=0.25)
    p_np, s_np, meta = load_npz(path)
    ck = load_checkpoint(path)
    assert meta == ck["meta"] and meta["epoch"] == 3
    for a, b in zip(jax.tree.leaves(p_np), jax.tree.leaves(ck["params"])):
        np.testing.assert_array_equal(a, b)
    assert (jax.tree.structure(s_np)
            == jax.tree.structure(jax.tree.map(np.asarray, ck["bn_state"])))
    from_file = Matcher(path, device="cpu", **TINY)   # load_state_dict(strict=True)
    from_trees = Matcher(params=params, bn_state=state, device="cpu", **TINY)
    assert from_file.meta["epoch"] == 3
    pair = _pair(701)
    a, b = from_file.match(**pair), from_trees.match(**pair)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])


def test_reference_pth_loads_strict(trees, tmp_path):
    """A reference-layout ``.pth`` training checkpoint (DataParallel
    ``module.`` keys, five fields) loads straight into the port."""
    params, state = trees
    path = str(tmp_path / "best_model.pth")
    save_pth_checkpoint(path, params, state, jax_test_defaults(**TINY),
                        epoch=2, dtype=np.float64)
    sd = load_pth_state_dict(path)
    assert not any(k.startswith("module.") for k in sd)
    from_pth = Matcher(path, device="cpu", **TINY)
    from_trees = Matcher(params=params, bn_state=state, device="cpu", **TINY)
    pair = _pair(702)
    a, b = from_pth.match(**pair), from_trees.match(**pair)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])
    with pytest.raises(ValueError, match="BOTH"):
        Matcher(params=params, device="cpu", **TINY)


def test_import_pulls_in_no_jax():
    code = ("import sys, mdgat_tpu_torch, mdgat_tpu_torch.ops.cuda.layer, "
            "mdgat_tpu_torch.ops.cuda.sinkhorn; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'mdgat_tpu.')) or m == 'mdgat_tpu']; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("descriptor,net", [
    ("FPFH", "mdgat"), ("FPFH_only", "mdgat"), ("FPFH_gloabal", "mdgat"),
    ("pointnet", "mdgat"), ("pointnet", "superglue"),
    ("pointnetmsg", "mdgat")])
def test_every_descriptor_tree_round_trips(descriptor, net):
    """A reference-layout state dict of each ``(descriptor, net)`` of
    ``tests/test_convert.py`` loads into the port's model with
    ``strict=True``; through the JAX package's ``convert_pth_state_dict``
    and back through ``state_dict_from_numpy`` it gives the key set, the
    shapes and the values of ``export_pth_state_dict``."""
    import torch_ref
    from mdgat_tpu.core.checkpoint import convert_pth_state_dict
    from mdgat_tpu_torch.models.factory import build_model
    cfg = jax_test_defaults(**dict(TINY, L=2, k=(8, None, 4, None)),
                            descriptor=descriptor, net=net)
    ref = {k: np.asarray(v) for k, v in
           torch_ref.make_state_dict(cfg, seed=7, module_prefix=False).items()}
    pcfg = port_defaults(**dict(TINY, L=2, k=(8, None, 4, None)),
                         descriptor=descriptor, net=net)
    model = build_model(pcfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in ref.items()},
                          strict=True)
    params, state = convert_pth_state_dict(ref, cfg)
    params = jax.tree.map(np.asarray, params)
    state = jax.tree.map(np.asarray, state)
    got = state_dict_from_numpy(params, state, pcfg)
    want = export_pth_state_dict(params, state, cfg, dtype=np.float64,
                                 module_prefix=False)
    assert sorted(got) == sorted(want) == sorted(model.state_dict()) \
        == sorted(ref)
    for key, val in want.items():
        assert tuple(got[key].shape) == val.shape, key
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(got[key].numpy(), val, err_msg=key)
            np.testing.assert_array_equal(val, ref[key], err_msg=key)
    model.load_state_dict(got, strict=True)


def test_unknown_descriptor_raises():
    with pytest.raises(ValueError, match="unknown descriptor"):
        state_dict_from_numpy({}, {}, port_defaults(descriptor="SHOT"))
    with pytest.raises(ValueError, match="Invalid descriptor"):
        MDGAT(port_defaults(descriptor="SHOT"))
