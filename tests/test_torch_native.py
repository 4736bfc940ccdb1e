"""The port's native threaded keypoint loader (``mdgat_tpu_torch/native``)
against the JAX package's (``mdgat_tpu/native``) and the numpy path, on
synthetic keypoint files: the same bits over ``ensure_kpts_num`` and
``max_kpts``, the same errors, the zero-filled all-filtered frame, a rebuild
when the source changes, and ``SparseDataset.batches(use_native=True)``
equal to ``use_native=False`` (the counterpart of ``tests/test_native.py``).
"""

import os

import numpy as np
import pytest

from mdgat_tpu.data.kitti import read_keypoint_bin
from mdgat_tpu.data.pipeline import duplicate_pad
from mdgat_tpu.data.synthetic import make_synthetic_pair, pair_to_bin_rows
from mdgat_tpu.native import NativeLoader as JaxNativeLoader
from mdgat_tpu.native import native_available as jax_native_available

from mdgat_tpu_torch.core.config import train_defaults
from mdgat_tpu_torch.data.pipeline import SparseDataset
from mdgat_tpu_torch.data.synthetic import write_synthetic_kitti
from mdgat_tpu_torch.native import NativeLoader, loader as port_loader


def _write(path, n, seed, low=3.0, every=7):
    rng = np.random.default_rng(seed)
    p = make_synthetic_pair(rng, n_points=n)
    p["score0"][::every] = low            # some rows below the filter
    pair_to_bin_rows(p["kp0"], p["score0"], p["desc0"]).tofile(path)
    return path


@pytest.fixture(scope="module")
def bin_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_bins")
    return [_write(str(d / f"{i:06d}.bin"), n, i)
            for i, n in enumerate([50, 200, 300, 1])]


def _numpy_path(path, max_kpts, ensure, score_min):
    kp, score, desc = read_keypoint_bin(path)
    if ensure:
        keep = score > score_min
        kp, score, desc = kp[keep], score[keep], desc[keep]
        n = max_kpts if len(kp) else 0
        if max_kpts < len(kp):
            kp, score, desc = kp[:max_kpts], score[:max_kpts], desc[:max_kpts]
        else:
            kp, score, desc = duplicate_pad(kp, score, desc, max_kpts)
        return kp, score, desc, n
    n = min(len(kp), max_kpts)
    out = [np.zeros((max_kpts, 3), np.float32),
           np.zeros((max_kpts,), np.float32),
           np.zeros((max_kpts, 33), np.float32)]
    out[0][:n], out[1][:n], out[2][:n] = kp[:n], score[:n], desc[:n]
    return (*out, n)


@pytest.mark.parametrize("ensure", [True, False])
@pytest.mark.parametrize("max_kpts", [1, 128, 256])
def test_port_loader_equals_jax_and_numpy(bin_files, ensure, max_kpts):
    """Every buffer and count bit-equal to the JAX package's loader (where
    it builds) and to the numpy path."""
    got = NativeLoader(max_kpts, ensure, 10.0, n_threads=3).load(bin_files)
    if jax_native_available():
        want = JaxNativeLoader(max_kpts, ensure, 10.0, n_threads=2).load(
            bin_files)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    kp, score, desc, counts = got
    for i, path in enumerate(bin_files):
        rkp, rsc, rde, rn = _numpy_path(path, max_kpts, ensure, 10.0)
        assert counts[i] == rn
        np.testing.assert_array_equal(kp[i], rkp.astype(np.float32))
        np.testing.assert_array_equal(score[i], rsc.astype(np.float32))
        np.testing.assert_array_equal(desc[i], rde.astype(np.float32))


def test_missing_file_raises(bin_files, tmp_path):
    loader = NativeLoader(64, True)
    with pytest.raises(IOError, match="native loader failed"):
        loader.load([bin_files[0], str(tmp_path / "absent.bin")])


def test_all_filtered_frame_zero_fills(tmp_path):
    """Every row below the score filter: zero-filled, count 0 (the numpy
    path's empty-frame contract), not an error."""
    path = _write(str(tmp_path / "000000.bin"), 40, 1, low=1.0, every=1)
    kp, score, desc, counts = NativeLoader(64, True, 10.0).load([path])
    assert counts.tolist() == [0]
    assert not kp.any() and not score.any() and not desc.any()


def test_rebuild_after_the_source_changes(tmp_path, monkeypatch):
    """The build lands in the build directory under a name keyed by the
    source: an edited source builds a new library beside the old one, and
    the source's directory gains no file."""
    src = tmp_path / "src" / "loader.cc"
    src.parent.mkdir()
    src.write_bytes(port_loader.SRC.read_bytes())
    monkeypatch.setattr(port_loader, "SRC", src)
    monkeypatch.setattr(port_loader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(port_loader, "_libs", {})
    first = port_loader.library_path()
    assert port_loader.load_library() is not None and first.exists()
    src.write_text(src.read_text() + "\n// edited\n")
    second = port_loader.library_path()
    assert second != first and not second.exists()
    assert port_loader.load_library() is not None and second.exists()
    assert sorted(os.listdir(src.parent)) == ["loader.cc"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("native_tree"))
    kp_dir = write_synthetic_kitti(root, seqs=(0, 2, 3, 4, 5, 6, 7, 10),
                                   frames_per_seq=5, pairs_per_seq=6,
                                   n_points=150, seed=4)
    return dict(train_path=root, keypoints_path=kp_dir,
                txt_path=os.path.join(root, "preprocess-random-full"),
                max_keypoints=96, memory_is_enough=False)


@pytest.mark.parametrize("ensure", [True, False], ids=["fixed", "bucketed"])
@pytest.mark.parametrize("compute", ["float32", "float64"])
def test_batches_native_equal_numpy(tree, ensure, compute):
    """The disk path through the native loader (counted) yields the numpy
    path's batches bit for bit, rows= shares included."""
    cfg = train_defaults(**tree, ensure_kpts_num=ensure, compute_dtype=compute)
    ds = SparseDataset(cfg, "train")
    before = NativeLoader.batches_loaded
    for kw in ({}, {"rows": slice(2, 4)}):
        got = list(ds.batches(4, shuffle=True, seed=3, **kw))
        want = list(ds.batches(4, shuffle=True, seed=3, use_native=False,
                               **kw))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                if k == "sequence":
                    assert g[k] == w[k]
                else:
                    assert g[k].dtype == w[k].dtype, k
                    np.testing.assert_array_equal(g[k], w[k], k)
        assert NativeLoader.batches_loaded - before == len(want)
        before = NativeLoader.batches_loaded


def test_memory_path_reads_no_file_natively(tree):
    ds = SparseDataset(train_defaults(**dict(tree, memory_is_enough=True)),
                       "train")
    before = NativeLoader.batches_loaded
    assert list(ds.batches(4)) and NativeLoader.batches_loaded == before
