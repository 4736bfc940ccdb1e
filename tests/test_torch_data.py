"""Port parity of the training data path (``mdgat_tpu_torch.data`` and
``ops.geometry``) against the JAX package: the synthetic pair generator,
``duplicate_pad``, ground-truth correspondences (both rules, masked) and
the device preprocessing of a batch.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mdgat_tpu.data import pipeline as jpipe
from mdgat_tpu.data import synthetic as jsyn
from mdgat_tpu.ops import geometry as jgeo

from mdgat_tpu_torch.data import pipeline as pipe
from mdgat_tpu_torch.data import synthetic as syn
from mdgat_tpu_torch.ops import geometry as geo


def test_synthetic_pair_and_dataset_equal_the_jax_packages():
    a = syn.make_synthetic_pair(np.random.default_rng(5), n_points=50,
                                overlap=0.6)
    b = jsyn.make_synthetic_pair(np.random.default_rng(5), n_points=50,
                                 overlap=0.6)
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])
    da = syn.SyntheticDataset(n_pairs=3, n_points=20, seed=7, jitter=0.01)
    db = jsyn.SyntheticDataset(n_pairs=3, n_points=20, seed=7, jitter=0.01)
    assert len(da) == len(db) == 3
    np.testing.assert_array_equal(da[2]["kp1"], db[2]["kp1"])


@pytest.mark.parametrize("count,target", [(5, 12), (7, 8), (12, 12), (0, 6)])
def test_duplicate_pad_equals_the_jax_packages(count, target):
    rng = np.random.default_rng(count)
    kp, sc, de = (rng.normal(size=(count, 3)), rng.normal(size=count),
                  rng.normal(size=(count, 33)))
    got = pipe.duplicate_pad(kp, sc, de, target)
    want = jpipe.duplicate_pad(kp, sc, de, target)
    for g, w in zip(got, want):
        assert g.shape[0] == target
        np.testing.assert_array_equal(g, w)


def _clouds(seed, b=3, n=30, m=26):
    rng = np.random.default_rng(seed)
    kp0 = rng.uniform(-10, 10, (b, n, 3))
    kp1 = rng.uniform(-10, 10, (b, m, 3))
    kp1[:, :15] = kp0[:, :15] + rng.normal(scale=0.15, size=(b, 15, 3))
    kp1[:, 15:18] = kp0[:, 3:4] + rng.normal(scale=0.1, size=(b, 3, 3))
    m0 = np.arange(n)[None, :] < np.array([[30], [22], [9]])
    m1 = np.arange(m)[None, :] < np.array([[26], [12], [26]])
    return kp0, kp1, m0, m1


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("mutual", [False, True], ids=["nearest", "mutual"])
def test_gt_correspondences_equal_the_jax_packages(mutual, masked):
    kp0, kp1, m0, m1 = _clouds(51)
    if not masked:
        m0 = m1 = None
    jm = [None if x is None else jnp.asarray(x) for x in (m0, m1)]
    want = jgeo.gt_correspondences(jnp.asarray(kp0), jnp.asarray(kp1), 0.5,
                                   mutual, *jm)
    tm = [None if x is None else torch.from_numpy(x) for x in (m0, m1)]
    got = geo.gt_correspondences(torch.from_numpy(kp0), torch.from_numpy(kp1),
                                 0.5, mutual, *tm)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got.matches0 >= 0).sum() > 10
    np.testing.assert_allclose(
        geo.pairwise_dist2(torch.from_numpy(kp0), torch.from_numpy(kp1)).numpy(),
        np.asarray(jgeo.pairwise_dist2(jnp.asarray(kp0), jnp.asarray(kp1))),
        rtol=0, atol=1e-9)


def _pairs(seed, sizes):
    rng = np.random.default_rng(seed)
    out = []
    for n0, n1 in sizes:
        p = syn.make_synthetic_pair(rng, n_points=max(n0, n1), overlap=0.8,
                                    jitter=0.02, desc_noise=0.02)
        for key in ("kp0", "desc0", "score0"):
            p[key] = p[key][:n0]
        for key in ("kp1", "desc1", "score1"):
            p[key] = p[key][:n1]
        out.append(p)
    return out


@pytest.mark.parametrize("max_kp", [None, 40], ids=["bucket-masks", "fixed-40"])
def test_collate_and_prepare_batch_equal_the_jax_preprocessing(max_kp):
    """The host batch fed to both packages' device preprocessing: the same
    normalised descriptors (1e-12) and the same ground truth."""
    host = pipe.collate_pairs(_pairs(61, [(40, 36), (30, 44), (48, 25)]),
                              max_keypoints=max_kp, dtype=np.float64, bucket=16)
    n = 40 if max_kp else 48
    assert host["keypoints0"].shape == (3, n, 3)
    assert host["mask0"].sum(1).tolist() == ([40] * 3 if max_kp else [40, 30, 48])
    if max_kp:     # duplicate pad: slot 0 repeats the cloud's first rows
        np.testing.assert_array_equal(host["keypoints0"][1, :10],
                                      host["keypoints0"][1, 10:20])
    want = jpipe.prepare_batch_fn(0.5, False, "float64", "float64")(
        {**host, "sequence": ["00"] * 3})
    got = pipe.prepare_batch(host, 0.5, False, "cpu", torch.float64,
                             torch.float64)
    for key in ("keypoints0", "keypoints1", "scores0", "scores1",
                "descriptors0", "descriptors1"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=1e-12, err_msg=key)
    for key in ("gt_matches0", "gt_matches1", "rep", "mask0", "mask1"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert int((got["gt_matches0"] >= 0).sum()) > 30
    assert sorted(pipe.model_inputs(got)) == sorted(pipe.MODEL_KEYS)


def test_zero_descriptor_rows_normalise_to_zero():
    host = pipe.collate_pairs(_pairs(62, [(20, 20)]), bucket=32)
    got = pipe.prepare_batch(host, 0.5, False, "cpu")
    assert torch.isfinite(got["descriptors0"]).all()
    assert not got["descriptors0"][0, 20:].any()
    np.testing.assert_allclose(
        torch.linalg.vector_norm(got["descriptors0"][0, :20], dim=-1).numpy(),
        1.0, rtol=0, atol=1e-6)
