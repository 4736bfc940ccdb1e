"""The port's eval pipeline (``mdgat_tpu_torch/eval/runner.py``): the cases
of ``tests/test_eval_pipeline.py`` (a producer error reaches the caller; a
healthy dataset yields every batch), the padded tail trimmed back, the
one-batch-delayed readback, an early stop, and the real pipeline on
``--device cpu`` over a synthetic KITTI-layout tree: every pair once, in
order, each batch's outputs equal to a forward over exactly its pairs."""

import numpy as np
import pytest
import torch

from mdgat_tpu_torch.core.config import test_defaults as eval_defaults
from mdgat_tpu_torch.data.pipeline import SparseDataset, prepare_batch
from mdgat_tpu_torch.data.synthetic import write_synthetic_kitti
from mdgat_tpu_torch.eval.runner import EvalPipeline, eval_model, eval_pipeline


def _batch(i, n=2):
    return {"idx0": np.arange(2 * i, 2 * i + n),
            "sequence": ["10"] * n,
            "gt_matches0": np.full((n, 4), i, np.int32),
            "mask0": np.ones((n, 4), bool)}


class _Dataset:
    def __init__(self, sizes, fail_after=None):
        self.sizes, self.fail_after = sizes, fail_after

    def batches(self, batch_size, shuffle=False, drop_last=False):
        assert not shuffle and not drop_last
        for i, n in enumerate(self.sizes):
            if i == self.fail_after:
                raise IOError("keypoint file vanished mid-eval")
            yield _batch(i, n)


class _Log:
    """prepare / eval_step that log what ran, on torch tensors."""

    def __init__(self):
        self.events = []

    def prepare(self, batch):
        self.events.append(("prepare", int(batch["idx0"][0]),
                            len(batch["idx0"])))
        out = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()
               if k != "sequence"}
        out["sequence"] = batch["sequence"]
        return out

    def eval_step(self, inputs):
        assert set(inputs) == {"gt_matches0", "mask0"}   # model inputs only
        self.events.append(("step", int(inputs["gt_matches0"][0, 0])))
        return {"matches0": inputs["gt_matches0"] * 10}


def _pipeline(dataset, log, batch_size=2):
    return EvalPipeline(dataset, log.prepare, log.eval_step, batch_size)


def test_producer_error_propagates():
    """A mid-dataset IO error reaches the caller: no silent truncation into
    plausible partial metrics."""
    with pytest.raises(IOError, match="vanished"):
        list(_pipeline(_Dataset([2, 2, 2], fail_after=1), _Log()))


def test_healthy_dataset_yields_all_batches():
    results = list(_pipeline(_Dataset([2, 2, 2]), _Log()))
    assert len(results) == 3
    for i, (batch, got) in enumerate(results):
        assert set(got) == {"matches0", "gt_matches0"}
        assert all(isinstance(v, np.ndarray) for v in got.values())
        np.testing.assert_array_equal(got["gt_matches0"], np.full((2, 4), i))
        np.testing.assert_array_equal(got["matches0"], np.full((2, 4), 10 * i))
        np.testing.assert_array_equal(batch["idx0"], [2 * i, 2 * i + 1])


def test_padded_tail_is_trimmed_back():
    """A remainder batch of 1 of 3 runs at the full batch shape (its last
    pair repeated) and comes back with its one real row."""
    log = _Log()
    results = list(_pipeline(_Dataset([3, 3, 1]), log, batch_size=3))
    assert [len(b["idx0"]) for b, _ in results] == [3, 3, 1]
    # every prepare saw the full batch size
    assert [e[2] for e in log.events if e[0] == "prepare"] == [3, 3, 3]
    batch, got = results[-1]
    assert "__n_real__" not in batch
    assert batch["sequence"] == ["10"] and batch["mask0"].shape == (1, 4)
    assert got["matches0"].shape == got["gt_matches0"].shape == (1, 4)
    np.testing.assert_array_equal(got["gt_matches0"], np.full((1, 4), 2))


def test_readback_is_one_batch_behind():
    """Batch i is handed to the caller only after batch i+1 was prepared
    and its eval step enqueued (the last one after the dataset ended)."""
    log = _Log()
    seen = []
    for batch, _ in _pipeline(_Dataset([2, 2, 2, 2]), log):
        i = int(batch["idx0"][0]) // 2
        seen.append(i)
        steps = [e[1] for e in log.events if e[0] == "step"]
        assert steps == list(range(min(i + 2, 4))), (i, steps)
    assert seen == [0, 1, 2, 3]


def test_early_stop_ends_the_producer():
    """A caller that stops after one batch (``--max_pairs``) stops the
    producer thread too."""
    import threading
    before = threading.active_count()
    it = iter(_pipeline(_Dataset([2] * 50), _Log()))
    next(it)
    it.close()
    for _ in range(50):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.05)
    assert threading.active_count() <= before


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kd"))
    kp_dir = write_synthetic_kitti(root, seqs=(10,), frames_per_seq=5,
                                   pairs_per_seq=11, n_points=70, seed=1)
    return root, kp_dir


def test_real_pipeline_on_the_cpu(tree):
    """Eleven pairs in batches of 4 (the tail of 3 padded): every pair once
    and in order, host arrays as the dataset gives them, and each batch's
    matches equal to the model's forward over exactly its real pairs."""
    root, kp_dir = tree
    import os
    cfg = eval_defaults(L=2, batch_size=4, compute_dtype="float64",
                        param_dtype="float64", train_path=root,
                        keypoints_path=kp_dir,
                        txt_path=os.path.join(root, "preprocess-random-full"),
                        resume_model=os.path.join(root, "absent.pth"))
    model, source = eval_model(cfg, "cpu")
    assert source == "missing" and not model.training
    results = list(eval_pipeline(cfg, model, "cpu",
                                 ("matches0", "matching_scores0")))
    assert [len(b["idx0"]) for b, _ in results] == [4, 4, 3]
    dataset = SparseDataset(cfg, "test")
    want_idx = [p["anc_idx"] for p in dataset.pairs]
    assert np.concatenate([b["idx0"] for b, _ in results]).tolist() == want_idx
    direct = list(dataset.batches(4, shuffle=False, drop_last=False))
    for (batch, got), host in zip(results, direct):
        for k in ("keypoints0", "mask1", "T_gt"):
            np.testing.assert_array_equal(batch[k], host[k])
        prepared = prepare_batch(host, cfg.threshold, cfg.mutual_check,
                                 "cpu", torch.float64, torch.float64)
        with torch.no_grad():
            out = model({k: v for k, v in prepared.items()
                         if isinstance(v, torch.Tensor)})
        np.testing.assert_array_equal(got["matches0"],
                                      out["matches0"].numpy())
        np.testing.assert_allclose(got["matching_scores0"],
                                   out["matching_scores0"].numpy(),
                                   rtol=0, atol=1e-12)
        np.testing.assert_array_equal(got["gt_matches0"],
                                      prepared["gt_matches0"].numpy())
        assert got["gt_matches0"].dtype == np.int32


def test_absent_cuda_device_raises(tree, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_model(eval_defaults(L=2), "cuda")
