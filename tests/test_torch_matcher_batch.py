"""The ``Matcher``'s serving batch on the CPU: ``Matcher._host_batch`` pads
every pair in one pass and leaves the descriptors raw, and the upload
(``parallel/smap.py::upload``) L2-normalises them on the batch's device.

The oracle is the per-pair build the Matcher used before, kept here: each
cloud cast and padded to its own bucket, its descriptors normalised with
numpy, then every field stacked at the batch's bucket. Keypoints, scores
and masks equal it exactly; the descriptors within 2 ulp of the unit
rows' scale (an ulp of 1.0), since only the summation order of the norm
differs. Then ``match_batch`` with ``normalize=True`` against the same
pairs normalised by the caller, on one device and on grids, and the one
``_host_batch`` call a ``match_batch`` that the benchmark's span reads.
"""

import numpy as np
import pytest
import torch

from mdgat_tpu_torch import Matcher

TINY = dict(L=2, k=(8, None, 4, None), descriptor_dim=32,
            keypoint_encoder=(16, 32), descriptor_encoder=(16,),
            sinkhorn_iterations=8)

# (cloud 0, cloud 1) sizes: 1, 127, 128, 129 and 300 keypoints, the sides
# of one pair in different buckets
SIZES = [(1, 129), (127, 300), (128, 1), (129, 128), (300, 127)]


def _pairs(seed=5, sizes=SIZES):
    """Ragged float64 pairs; pair 1 has no ``score0`` and pair 2 no
    ``score1``; pair 3's first descriptor row is all zero."""
    rng = np.random.default_rng(seed)
    out = []
    for i, (n0, n1) in enumerate(sizes):
        p = dict(kp0=rng.uniform(-30, 30, (n0, 3)),
                 desc0=np.abs(rng.normal(size=(n0, 33))),
                 score0=rng.uniform(10, 30, n0),
                 kp1=rng.uniform(-30, 30, (n1, 3)),
                 desc1=np.abs(rng.normal(size=(n1, 33))),
                 score1=rng.uniform(10, 30, n1))
        if i == 1:
            del p["score0"]
        if i == 2:
            p["score1"] = None
        if i == 3:
            p["desc0"][0] = 0.0
        out.append(p)
    return out


def _per_pair_build(pairs, normalize, dt):
    """The Matcher's build before it was vectorised: the oracle."""
    def pad(kp, desc, score):
        kp, desc, n = np.asarray(kp, dt), np.asarray(desc, dt), len(kp)
        score = (np.full((n,), 20.0, dt) if score is None
                 else np.asarray(score, dt))
        tgt = max(-(-n // 128) * 128, 128)
        out = (np.zeros((tgt, 3), dt), np.zeros((tgt, desc.shape[1]), dt),
               np.zeros((tgt,), dt), np.zeros((tgt,), bool))
        out[0][:n], out[1][:n], out[2][:n], out[3][:n] = kp, desc, score, 1
        if normalize:
            nrm = np.linalg.norm(out[1][:n], axis=1, keepdims=True)
            out[1][:n] /= np.maximum(nrm, 1e-12)
        return out

    padded = [pad(p["kp0"], p["desc0"], p.get("score0"))
              + pad(p["kp1"], p["desc1"], p.get("score1")) for p in pairs]
    names = ("keypoints0", "descriptors0", "scores0", "mask0",
             "keypoints1", "descriptors1", "scores1", "mask1")
    batch = {}
    for i, name in enumerate(names):
        tgt = max(x[i].shape[0] for x in padded)
        out = np.zeros((len(padded), tgt) + padded[0][i].shape[1:],
                       padded[0][i].dtype)
        for b, x in enumerate(padded):
            out[b, :x[i].shape[0]] = x[i]
        batch[name] = out
    return batch


@pytest.mark.parametrize("normalize", [True, False], ids=["norm", "raw"])
@pytest.mark.parametrize("compute, host", [
    ("float32", np.float32), ("float64", np.float64),
    ("bfloat16", np.float32)])
def test_prepare_batch_equals_the_per_pair_build(compute, host, normalize):
    """Fields, dtypes and buckets of the old build; ``score=None`` reads
    20.0; padded rows are zero, an all-zero descriptor row stays zero, and
    ``normalize=False`` leaves the descriptors as given."""
    pairs = _pairs()
    m = Matcher(device="cpu", seed=0, compute_dtype=compute, **TINY)
    got, sizes = m.prepare_batch(pairs, normalize)
    assert sizes == [(len(p["kp0"]), len(p["kp1"])) for p in pairs]
    want = _per_pair_build(pairs, normalize, np.dtype(host))
    assert list(got) == list(want)
    assert got["keypoints0"].shape == (5, 384, 3)
    assert got["descriptors1"].shape == (5, 384, 33)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k.startswith("descriptors") and normalize:
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=2 * np.finfo(host).eps,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    assert (got["scores0"][1, :127] == 20.0).all()
    assert (got["scores1"][2, :1] == 20.0).all()
    assert (got["descriptors0"][3, 0] == 0).all()
    for side in "01":
        pad = ~got["mask" + side]
        for field in ("keypoints", "descriptors", "scores"):
            assert (got[field + side][pad] == 0).all(), field + side
        if normalize:
            norms = torch.linalg.vector_norm(
                got["descriptors" + side][got["mask" + side]].double(),
                dim=-1)
            zero = norms == 0
            assert int(zero.sum()) == (side == "0")
            np.testing.assert_allclose(norms[~zero].numpy(), 1.0,
                                       rtol=4 * np.finfo(host).eps)


@pytest.mark.parametrize("normalize", [True, False], ids=["norm", "raw"])
def test_host_batch_leaves_the_descriptors_raw(normalize):
    """The host half is a pad and a cast, whatever the flag: the
    normalisation waits for the upload."""
    pairs = _pairs(sizes=SIZES[:2])
    m = Matcher(device="cpu", seed=0, compute_dtype="float32", **TINY)
    got, _ = m._host_batch(pairs, normalize)
    want = _per_pair_build(pairs, False, np.dtype(np.float32))
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


@pytest.mark.parametrize("grid", [(1, 1), (2, 1), (1, 2)],
                         ids=lambda g: f"{g[0]}x{g[1]}")
def test_match_batch_normalises_in_every_cell(grid):
    """``normalize=True`` equals the caller normalising each pair with
    numpy and passing ``normalize=False``, on one device and in each cell
    of a data grid and of a seq row; a 3-pair batch leaves the 2 x 1 grid
    a fill row."""
    n, s = grid
    m = Matcher(device="cpu", seed=2, data_parallel=n, seq_parallel=s,
                compute_dtype="float64", param_dtype="float64", **TINY)
    pairs = _pairs(seed=9, sizes=[(40, 60), (128, 90), (70, 129)])

    def unit(d):
        return d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True),
                              1e-12)
    done = [dict(p, desc0=unit(p["desc0"]), desc1=unit(p["desc1"]))
            for p in pairs]
    got = m.match_batch(pairs)
    want = m.match_batch(done, normalize=False)
    raw = m.match_batch(pairs, normalize=False)
    assert any(not np.allclose(g["matching_scores0"], r["matching_scores0"])
               for g, r in zip(got, raw))       # the flag reaches the cells
    for g, w in zip(got, want):
        for key in ("matches0", "matches1"):
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
        for key in ("matching_scores0", "matching_scores1"):
            np.testing.assert_allclose(g[key], w[key], rtol=0, atol=1e-9,
                                       err_msg=key)


@pytest.mark.parametrize("grid", [(1, 1), (2, 1)],
                         ids=lambda g: f"{g[0]}x{g[1]}")
def test_match_batch_calls_the_host_batch_once(grid):
    """An instance-level wrapper of ``_host_batch`` (how the benchmark
    times it) sees one call a ``match_batch``, with the caller's flag."""
    n, s = grid
    m = Matcher(device="cpu", seed=0, data_parallel=n, seq_parallel=s,
                **TINY)
    calls = []
    inner = m._host_batch

    def wrapped(*args, **kwargs):
        calls.append(args[1:] + tuple(kwargs.values()))
        return inner(*args, **kwargs)
    m._host_batch = wrapped
    pairs = _pairs(sizes=SIZES[:3])
    m.match_batch(pairs)
    m.match_batch(pairs, normalize=False)
    m.match(**{k: v for k, v in pairs[0].items()})
    assert calls == [(True,), (False,), (True,)]
