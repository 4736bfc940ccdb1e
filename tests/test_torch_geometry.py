"""The pose half of the port's geometry (``mdgat_tpu_torch/ops/geometry.py``)
against ``mdgat_tpu/ops/geometry.py``: the same seeded numpy inputs through
both, float64, to 1e-10. Batched, weighted and unweighted fits, a reflected
cloud (where ``kabsch`` keeps det(R) = -1 and ``kabsch_proper`` fixes it),
registration errors with and without the arccos clamp, inlier counts."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mdgat_tpu.ops import geometry as jgeo

from mdgat_tpu_torch.ops import geometry as geo

TOL = 1e-10


def _rigid(rng, b):
    """[b, 4, 4] random rotations (any axis, up to ~1 rad) and shifts."""
    T = np.tile(np.eye(4), (b, 1, 1))
    for i in range(b):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        th = rng.uniform(-1.0, 1.0)
        K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        T[i, :3, :3] = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
        T[i, :3, 3] = rng.normal(scale=5.0, size=3)
    return T


def _clouds(seed, b=5, n=40, noise=0.05):
    """P [b, n, 3], Q = T P + noise, T, weights [b, n] with zeros."""
    rng = np.random.default_rng(seed)
    T = _rigid(rng, b)
    P = rng.normal(scale=10.0, size=(b, n, 3))
    Q = (np.einsum("bij,bnj->bni", T[:, :3, :3], P) + T[:, None, :3, 3]
         + rng.normal(scale=noise, size=(b, n, 3)))
    w = (rng.uniform(size=(b, n)) < 0.7).astype(np.float64)
    w[:, :4] = 1.0
    return P, Q, T, w


def _port(fn, *args, **kw):
    out = fn(*[None if a is None else torch.from_numpy(np.asarray(a))
               for a in args], **kw)
    if isinstance(out, tuple):
        return tuple(o.numpy() for o in out)
    return out.numpy()


def _jax(fn, *args, **kw):
    out = fn(*[None if a is None else jnp.asarray(a) for a in args], **kw)
    if isinstance(out, tuple):
        return tuple(np.asarray(o) for o in out)
    return np.asarray(out)


def test_transform_points():
    P, _, T, _ = _clouds(0)
    got = _port(geo.transform_points, T, P)
    np.testing.assert_allclose(got, _jax(jgeo.transform_points, T, P),
                               rtol=0, atol=TOL)
    assert got.dtype == np.float64


@pytest.mark.parametrize("fit", ["kabsch", "kabsch_proper"])
@pytest.mark.parametrize("weighted", [False, True])
def test_fits_equal_the_jax_package(fit, weighted):
    P, Q, T_true, w = _clouds(1 + weighted)
    w = w if weighted else None
    got = _port(getattr(geo, fit), P, Q, w)
    want = _jax(getattr(jgeo, fit), P, Q, w)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # and both recover the transform the noise was added to
    np.testing.assert_allclose(got, T_true, rtol=0, atol=0.05)
    assert got.shape == (5, 4, 4)


def test_reflection_kabsch_keeps_it_kabsch_proper_fixes_it():
    """Q a mirror image of P: the plain fit (like the reference) returns an
    improper R with det -1, the proper fit one with det +1; each equal to
    its counterpart in the JAX package."""
    P, _, _, w = _clouds(3, b=3, noise=0.0)
    Q = P * np.array([1.0, 1.0, -1.0])
    for weights in (None, w):
        plain = _port(geo.kabsch, P, Q, weights)
        proper = _port(geo.kabsch_proper, P, Q, weights)
        np.testing.assert_allclose(plain, _jax(jgeo.kabsch, P, Q, weights),
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(
            proper, _jax(jgeo.kabsch_proper, P, Q, weights), rtol=0, atol=TOL)
        np.testing.assert_allclose(np.linalg.det(plain[:, :3, :3]), -1.0,
                                   atol=1e-9)
        np.testing.assert_allclose(np.linalg.det(proper[:, :3, :3]), 1.0,
                                   atol=1e-9)


@pytest.mark.parametrize("clamp", [False, True])
def test_registration_errors(clamp):
    """Near-identity errors push the arccos argument past 1 by rounding on
    some rows: NaN unclamped (the reference), 0 clamped; the NaN rows and
    every number the same in both packages."""
    P, Q, T_gt, _ = _clouds(4, b=6)
    T = _port(geo.kabsch, P, Q)
    T[3] = T_gt[3]                          # exact: tr(R) - 1 may round > 2
    T[4, :3, :3] = T_gt[4, :3, :3] @ np.diag([1, 1, 1 + 1e-12])
    rte, rre = _port(geo.registration_errors, T, T_gt, clamp_arccos=clamp)
    jrte, jrre = _jax(jgeo.registration_errors, T, T_gt, clamp_arccos=clamp)
    np.testing.assert_allclose(rte, jrte, rtol=0, atol=TOL)
    np.testing.assert_array_equal(np.isnan(rre), np.isnan(jrre))
    np.testing.assert_allclose(rre, jrre, rtol=0, atol=TOL, equal_nan=True)
    if clamp:
        assert np.isfinite(rre).all()
    # a pose over a reflection: arccos argument well inside [-1, 1]
    T_ref = T_gt.copy()
    T_ref[:, 2, :3] *= -1
    f_t = _port(geo.registration_errors, T_ref, T_gt, clamp_arccos=clamp)[1]
    np.testing.assert_allclose(
        f_t, _jax(jgeo.registration_errors, T_ref, T_gt,
                  clamp_arccos=clamp)[1], rtol=0, atol=TOL, equal_nan=True)


def test_registration_errors_unclamped_nan_past_one():
    T = np.tile(np.eye(4), (2, 1, 1))
    T_gt = T.copy()
    T_gt[1, :3, :3] *= 1 + 1e-6                 # tr(R) - 1 > 2: f > 1
    rre = _port(geo.registration_errors, T, T_gt)[1]
    assert rre[0] == 0.0 and np.isnan(rre[1])
    assert np.isnan(_jax(jgeo.registration_errors, T, T_gt)[1][1])
    assert _port(geo.registration_errors, T, T_gt, clamp_arccos=True)[1][1] == 0


@pytest.mark.parametrize("weighted", [False, True])
def test_inlier_count(weighted):
    P, Q, _, w = _clouds(5, noise=0.8)
    T = _port(geo.kabsch, P, Q)
    w = w if weighted else None
    # mkpts0 = Q, mkpts1 = P: cloud 1 moved by T into cloud 0
    got = _port(geo.inlier_count, T, Q, P, 1.0, w)
    want = _jax(jgeo.inlier_count, T, Q, P, 1.0, w)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.min() and got.max() < P.shape[1]   # a real threshold
    for radius in (0.5, 2.0):
        np.testing.assert_array_equal(
            _port(geo.inlier_count, T, Q, P, radius, w),
            _jax(jgeo.inlier_count, T, Q, P, radius, w))


def test_float32_inputs_stay_float32():
    """The dtype follows the inputs (the tests' workers may set torch's
    default dtype to float64)."""
    P, Q, T_gt, w = (a.astype(np.float32) for a in _clouds(6))
    T = _port(geo.kabsch_proper, P, Q, w)
    assert T.dtype == np.float32
    rte, rre = _port(geo.registration_errors, T, T_gt, clamp_arccos=True)
    assert rte.dtype == rre.dtype == np.float32
    assert _port(geo.transform_points, T, P).dtype == np.float32
