"""Port parity of the on-disk data path against the JAX package: the
synthetic KITTI-layout writer (byte for byte), the KITTI readers,
``SparseDataset.batches`` (array for array, both fixed-size policies, cached
and from disk, shuffled), ``prepare_batch`` on such batches, and the batch
prefetcher.
"""

import filecmp
import os
import threading

import numpy as np
import pytest
import torch

from mdgat_tpu.core.config import train_defaults as jax_train_defaults
from mdgat_tpu.data import kitti as jkitti
from mdgat_tpu.data import pipeline as jpipe
from mdgat_tpu.data import synthetic as jsyn

from mdgat_tpu_torch.core.config import train_defaults
from mdgat_tpu_torch.data import kitti, pipeline as pipe, prefetch
from mdgat_tpu_torch.data import synthetic as syn

SEQS = (0, 2, 3, 4, 5, 6, 7, 9, 10)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A synthetic KITTI-layout tree with keypoint counts that differ from
    frame to frame (every third file cut short, one emptied of points that
    pass the score filter), so that both fixed-size policies have work."""
    root = str(tmp_path_factory.mktemp("kitti"))
    kp_dir = syn.write_synthetic_kitti(root, seqs=SEQS, frames_per_seq=5,
                                       pairs_per_seq=6, n_points=150, seed=4)
    for seq in SEQS:
        for frame in range(0, 5, 3):
            path = os.path.join(kp_dir, "%02d" % seq, "%06d.bin" % frame)
            rows = np.fromfile(path, np.float32).reshape(-1, 37)
            rows = rows[:100 + 7 * seq + frame]
            if seq == 2 and frame == 0:
                rows[:, 3] = 1.0                  # below score_min = 10
            rows.tofile(path)
    return root, kp_dir


def _files(root):
    out = []
    for base, _, names in os.walk(root):
        out += [os.path.relpath(os.path.join(base, n), root) for n in names]
    return sorted(out)


@pytest.mark.parametrize("cloud_points", [0, 260])
def test_write_synthetic_kitti_is_byte_identical(tmp_path, cloud_points):
    kw = dict(seqs=(0, 9), frames_per_seq=4, pairs_per_seq=5, n_points=60,
              seed=11, cloud_points=cloud_points)
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    kp_a = syn.write_synthetic_kitti(a, **kw)
    kp_b = jsyn.write_synthetic_kitti(b, **kw)
    assert os.path.relpath(kp_a, a) == os.path.relpath(kp_b, b)
    names = _files(a)
    assert names == _files(b) and len(names) == 2 * (3 + 4 * (1 + bool(cloud_points)))
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors and len(match) == len(names)
    rows = np.fromfile(os.path.join(kp_a, "00", "000000.bin"), np.float32)
    np.testing.assert_array_equal(
        rows.reshape(-1, 37), syn.pair_to_bin_rows(
            *kitti.read_keypoint_bin(os.path.join(kp_a, "00", "000000.bin"))))


def test_kitti_readers_equal_the_jax_packages(tree, tmp_path):
    root, kp_dir = tree
    txt = os.path.join(root, "preprocess-random-full")
    assert kitti.SPLIT_SEQS == jkitti.SPLIT_SEQS
    assert kitti.KEYPOINT_ROW_FLOATS == jkitti.KEYPOINT_ROW_FLOATS == 37
    for mode in ("train", "val", "test"):
        assert (kitti.make_dataset_kitti_distance(txt, mode)
                == jkitti.make_dataset_kitti_distance(txt, mode))
    with pytest.raises(ValueError, match="Invalid mode"):
        kitti.make_dataset_kitti_distance(txt, "nope")
    calib = os.path.join(root, "calib", "sequences", "09", "calib.txt")
    got = kitti.load_calib(calib)
    np.testing.assert_array_equal(got, jkitti.load_calib(calib))
    # the last parsable line wins: the Tr line, not the P0 line before it
    assert not np.array_equal(got[:3], np.eye(3, 4))
    odd = tmp_path / "calib.txt"
    odd.write_text("P0: 1 0 0 0 0 1 0 0 0 0 1 0\nTr: 1 2 3 4 5 6 7 8 9 10 11 12\n"
                   "note: not numbers\nshort: 1 2 3\nno colon here\n")
    np.testing.assert_array_equal(kitti.load_calib(str(odd))[:3],
                                  np.arange(1.0, 13.0).reshape(3, 4))
    (tmp_path / "empty.txt").write_text("nothing\n")
    with pytest.raises(ValueError, match="no calib line"):
        kitti.load_calib(str(tmp_path / "empty.txt"))
    poses = os.path.join(root, "poses", "09.txt")
    np.testing.assert_array_equal(kitti.load_poses(poses),
                                  jkitti.load_poses(poses))
    frame = os.path.join(kp_dir, "09", "000003.bin")
    for g, w in zip(kitti.read_keypoint_bin(frame),
                    jkitti.read_keypoint_bin(frame)):
        np.testing.assert_array_equal(g, w)


def _configs(tree, **over):
    root, kp_dir = tree
    kw = dict(train_path=root, keypoints_path=kp_dir,
              txt_path=os.path.join(root, "preprocess-random-full"), **over)
    return train_defaults(**kw), jax_train_defaults(**kw)


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            if key == "sequence":
                assert g[key] == w[key]
                continue
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


@pytest.mark.parametrize("memory_is_enough", [True, False],
                         ids=["cached", "from_disk"])
@pytest.mark.parametrize("ensure_kpts_num", [True, False],
                         ids=["ensure_kpts_num", "bucketed"])
@pytest.mark.parametrize("compute_dtype", ["float32", "float64"])
def test_sparse_dataset_batches_equal_the_jax_packages(
        tree, ensure_kpts_num, memory_is_enough, compute_dtype):
    pcfg, jcfg = _configs(tree, ensure_kpts_num=ensure_kpts_num,
                          memory_is_enough=memory_is_enough,
                          max_keypoints=128, compute_dtype=compute_dtype)
    for mode in ("train", "val"):
        pset, jset = pipe.SparseDataset(pcfg, mode), jpipe.SparseDataset(jcfg, mode)
        assert len(pset) == len(jset) == (42 if mode == "train" else 6)
        for kw in (dict(shuffle=True, seed=3), dict(shuffle=False),
                   dict(shuffle=True, seed=4, drop_last=False)):
            got = list(pset.batches(4, **kw))
            want = list(jset.batches(4, use_native=False, **kw))
            _assert_batches_equal(got, want)
            if not kw.get("drop_last", True):
                assert len(got[-1]["idx0"]) == len(pset) % 4
    first = next(iter(pset.batches(4)))
    if ensure_kpts_num:
        assert first["keypoints0"].shape == (4, 128, 3) and first["mask0"].all()
    else:
        assert first["keypoints0"].shape[1] % 128 == 0
        assert not first["mask0"].all()


def test_sparse_dataset_cloud_without_valid_keypoints(tree):
    """Seq 2 frame 0 has no keypoint above ``score_min``: with
    ``ensure_kpts_num`` its cloud is zero-filled with an all-false mask, as
    in the JAX package."""
    pcfg, jcfg = _configs(tree, max_keypoints=64)
    pset, jset = pipe.SparseDataset(pcfg, "train"), jpipe.SparseDataset(jcfg, "train")
    hits = [i for i, r in enumerate(pset.pairs)
            if r["seq"] == 2 and 0 in (r["anc_idx"], r["pos_idx"])]
    assert hits
    for i in hits:
        got, want = pset.get_pair(i), jset.get_pair(i)
        side = "0" if pset.pairs[i]["anc_idx"] == 0 else "1"
        assert not got["mask" + side].any()
        assert not got["keypoints" + side].any()
        for key in want:
            if key != "sequence":
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("ensure_kpts_num", [True, False],
                         ids=["ensure_kpts_num", "bucketed"])
@pytest.mark.parametrize("compute_dtype", ["float32", "float64"])
def test_prepare_batch_on_dataset_batches_equals_prepare_batch_fn(
        tree, ensure_kpts_num, compute_dtype):
    pcfg, jcfg = _configs(tree, ensure_kpts_num=ensure_kpts_num,
                          max_keypoints=128, compute_dtype=compute_dtype)
    batch = next(iter(pipe.SparseDataset(pcfg, "train").batches(
        4, shuffle=True, seed=1)))
    tdt = torch.float64 if compute_dtype == "float64" else torch.float32
    got = pipe.prepare_batch(batch, pcfg.threshold, pcfg.mutual_check, "cpu",
                             tdt, tdt)
    want = jpipe.prepare_batch_fn(jcfg.threshold, jcfg.mutual_check,
                                  compute_dtype, compute_dtype)(batch)
    assert sorted(got) == sorted(want)
    assert int((got["gt_matches0"] >= 0).sum()) > 100
    for key, w in want.items():
        if key in pipe.HOST_KEYS:
            assert got[key] is batch[key]
            continue
        g = got[key].numpy()
        assert g.shape == w.shape, key
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, np.asarray(w), rtol=0,
                                       atol=1e-6 if tdt == torch.float32 else 1e-14,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=key)
    assert set(pipe.model_inputs(got)) == set(pipe.MODEL_KEYS)


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_prefetcher_yields_in_order_and_can_be_iterated_again(depth):
    main = threading.get_ident()
    seen = []

    def make_iter():
        for i in range(7):
            seen.append(threading.get_ident())
            yield i

    batches = prefetch.prefetch_batches(make_iter, depth)
    assert list(batches) == list(range(7))
    assert list(batches) == list(range(7))            # a fresh producer
    if depth == 0:
        assert not isinstance(batches, prefetch.BatchPrefetcher)
        assert set(seen) == {main}                    # serial: this thread
    else:
        assert isinstance(batches, prefetch.BatchPrefetcher)
        assert main not in seen


def test_prefetcher_reraises_a_producer_error_and_stops_when_abandoned():
    def failing():
        yield 1
        yield 2
        raise OSError("disk gone")

    got = []
    with pytest.raises(OSError, match="disk gone"):
        for item in prefetch.prefetch_batches(failing, 2):
            got.append(item)
    assert got == [1, 2]

    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield i
            i += 1

    it = iter(prefetch.prefetch_batches(endless, 2))
    assert next(it) == 0
    it.close()                                        # abandoned mid-epoch
    for _ in range(50):
        if not any(t.name == "batch-prefetch" and t.is_alive()
                   for t in threading.enumerate()):
            break
        threading.Event().wait(0.1)
    assert not any(t.name == "batch-prefetch" and t.is_alive()
                   for t in threading.enumerate())
    assert len(produced) < 10
    with pytest.raises(ValueError, match="depth"):
        prefetch.BatchPrefetcher(endless, 0)


@pytest.mark.parametrize("compute_dtype", ["float32", "float64"])
def test_sparse_dataset_clouds_equal_the_jax_packages(tmp_path, compute_dtype):
    """The learned-descriptor modes: a tree written with ``cloud_points``,
    ``SparseDataset.batches`` with ``cloud0`` / ``cloud1`` [B, Np, 8] equal
    to the JAX package's, and ``prepare_batch`` carrying them to the device
    as they are (not normalised) into ``model_inputs``."""
    root = str(tmp_path / "kd")
    kp_dir = syn.write_synthetic_kitti(root, seqs=SEQS, frames_per_seq=4,
                                       pairs_per_seq=3, n_points=40, seed=6,
                                       cloud_points=160)
    kw = dict(train_path=root, keypoints_path=kp_dir,
              txt_path=os.path.join(root, "preprocess-random-full"),
              descriptor="pointnetmsg", max_keypoints=32,
              compute_dtype=compute_dtype)
    pset = pipe.SparseDataset(train_defaults(**kw), "train")
    jset = jpipe.SparseDataset(jax_train_defaults(**kw), "train")
    got = list(pset.batches(4, shuffle=True, seed=2))
    _assert_batches_equal(got, list(jset.batches(4, shuffle=True, seed=2,
                                                 use_native=False)))
    first = got[0]
    assert first["cloud0"].shape == first["cloud1"].shape == (4, 160, 8)
    cloud = np.fromfile(os.path.join(root, "kitti_randomsample_16384_n8",
                                     "%02d" % pset.pairs[0]["seq"],
                                     "%06d.bin" % pset.pairs[0]["anc_idx"]),
                        np.float32).reshape(-1, 8)
    one = pset.get_pair(0)
    np.testing.assert_array_equal(one["cloud0"], cloud.astype(pset.host_dtype))
    tdt = torch.float64 if compute_dtype == "float64" else torch.float32
    prepared = pipe.prepare_batch(first, 0.5, False, "cpu", tdt, tdt)
    inputs = pipe.model_inputs(prepared)
    assert set(inputs) == set(pipe.MODEL_KEYS) | {"cloud0", "cloud1"}
    for key in ("cloud0", "cloud1"):
        np.testing.assert_array_equal(inputs[key].numpy(), first[key])
