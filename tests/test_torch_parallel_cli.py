"""The port's entry points as two processes on the CPU (gloo), started with
the JAX CLIs' three multi-process flags, against the same entry point as one
process (counterpart of the JAX package's ``tests/test_multihost.py``
CLI tests).

* ``test_torch.py`` and ``test_registration_metric_torch.py`` with
  ``--max_pairs 6 --batch_size 4`` (not a multiple: the cap is rounded up
  to whole batches before the pairs are split): rank 0 prints exactly the
  one-process run's aggregate lines, rank 1 prints none, and every pair's
  line is printed once, by the rank that owns it.
* ``train_torch.py`` for two steps: only rank 0 writes a checkpoint and
  logs, the checkpoint loads, and its weights are the one-process run's.
"""

import contextlib
import io
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import test_registration_metric_torch
import test_torch
import train_torch
from mdgat_tpu_torch.core.checkpoint import (load_pth_state_dict,
                                             load_train_checkpoint)
from mdgat_tpu_torch.core.config import train_defaults
from mdgat_tpu_torch.data.synthetic import write_synthetic_kitti
from mdgat_tpu_torch.train import create_train_state

from test_torch_eval_cli import _checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tiny tensors: one thread a rank (several ranks, each with a thread a core
# spinning at every collective, would crowd each other out)
RANK_ENV = dict(os.environ, OMP_NUM_THREADS="1")
SIZE = ["--l", "2", "--max_keypoints", "64", "--compute_dtype", "float64",
        "--device", "cpu", "--batch_size", "4"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ranks(script, argv, per_rank=((REPO, []), (REPO, []))):
    """``script`` as two ranks (``--coordinator_address``,
    ``--num_processes 2``, ``--process_id``), each in its working directory
    with its extra arguments (``per_rank``); the processes."""
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, os.path.join(REPO, script), *argv, *extra,
         "--coordinator_address", f"127.0.0.1:{port}", "--num_processes", "2",
         "--process_id", str(rank)],
        cwd=cwd, env=RANK_ENV, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for rank, (cwd, extra) in enumerate(per_rank)]


def _wait(procs):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


def _in_process(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def _aggregates(out):
    keys = ("average repeatibility", "baned_data", "repeatibility,")
    return [ln for ln in out.splitlines()
            if ln.startswith(keys) or " || " in ln]


def _pair_lines(out):
    return [ln for ln in out.splitlines()
            if ln.startswith("idx") or ln == "registration fail"]


@pytest.fixture(scope="module")
def eval_runs(tmp_path_factory):
    """Both eval entry points as two ranks (all four processes at once) and
    as one process, on one tree and one checkpoint that matches."""
    base = tmp_path_factory.mktemp("parallel_eval")
    root = str(base / "kd")
    kp_dir = write_synthetic_kitti(root, seqs=(10,), frames_per_seq=6,
                                   pairs_per_seq=10, n_points=100, seed=5)
    pth, _ = _checkpoint(base, 2)
    argv = ["--train_path", root, "--keypoints_path", kp_dir, "--txt_path",
            os.path.join(root, "preprocess-random-full"), "--resume_model",
            pth, "--max_pairs", "6", *SIZE]
    scripts = {"test": ("test_torch.py", test_torch.main),
               "reg": ("test_registration_metric_torch.py",
                       test_registration_metric_torch.main)}
    procs = {name: _ranks(script, argv) for name, (script, _) in
             scripts.items()}
    single = {name: _in_process(main, argv)
              for name, (_, main) in scripts.items()}
    return {name: (single[name], _wait(procs[name])) for name in scripts}


@pytest.mark.parametrize("name", ["test", "reg"])
def test_rank_zero_prints_the_one_process_aggregates(eval_runs, name):
    single, (rank0, rank1) = eval_runs[name]
    want = _aggregates(single)
    assert want and _aggregates(rank0) == want
    assert not _aggregates(rank1), "rank 1 printed aggregates"
    assert "multi-process: rank 0/2, device cpu, backend gloo" in rank0
    assert "multi-process: rank 1/2, device cpu, backend gloo" in rank1


@pytest.mark.parametrize("name", ["test", "reg"])
def test_each_pair_is_evaluated_once(eval_runs, name):
    """8 pairs (6 rounded up to two batches of 4), 4 a rank, in order: the
    one-process lines are rank 0's then rank 1's."""
    single, (rank0, rank1) = eval_runs[name]
    assert "[timing] 8 pairs" in single and "[timing] 4 pairs" in rank0
    assert _pair_lines(rank0) + _pair_lines(rank1) == _pair_lines(single)


def test_train_ranks_write_one_checkpoint(tmp_path):
    """Two ranks for two steps of batch 4 (two rows each): rank 0 alone
    writes the checkpoint and the logs; the checkpoint loads into a train
    state, and its weights and running statistics are those of the same
    run as one process."""
    root = str(tmp_path / "kd")
    kp_dir = write_synthetic_kitti(root, seqs=(0, 2, 3, 4, 5, 6, 7, 9, 10),
                                   frames_per_seq=5, pairs_per_seq=6,
                                   n_points=80, seed=2)
    argv = ["--train_path", root, "--keypoints_path", kp_dir, "--txt_path",
            os.path.join(root, "preprocess-random-full"), "--epoch", "1",
            "--steps_per_epoch", "2", "--learning_rate", "1e-3", *SIZE]
    cwds = []
    for rank in range(2):
        cwd = tmp_path / f"rank{rank}"
        cwd.mkdir()
        cwds.append((str(cwd), ["--model_out_path", str(cwd / "ck")]))
    procs = _ranks("train_torch.py", argv, cwds)
    one = tmp_path / "one"
    one.mkdir()
    old = os.getcwd()
    os.chdir(one)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            summary = train_torch.main(argv + ["--model_out_path",
                                               str(one / "ck")])
    finally:
        os.chdir(old)
    outs = _wait(procs)
    assert "Checkpoint saved to" in outs[0]
    assert "Checkpoint saved to" not in outs[1]
    assert os.path.isdir(os.path.join(cwds[0][0], "logs"))
    assert os.listdir(cwds[1][0]) == []
    found = [os.path.join(d, n) for d, _, names in os.walk(cwds[0][0])
             for n in names if n.endswith(".pth")]
    assert len(found) == 1
    cfg = train_defaults(L=2, max_keypoints=64, batch_size=4,
                         param_dtype="float64", compute_dtype="float64")
    state = create_train_state(cfg, device="cpu", seed=1)
    meta = load_train_checkpoint(found[0], state)
    assert meta["epoch"] == 1 and state.optimizer.state
    want = load_pth_state_dict(summary["checkpoints"][-1])
    got = load_pth_state_dict(found[0])
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key].numpy(), w.numpy(), rtol=1e-9,
                                   atol=1e-9, err_msg=key)
