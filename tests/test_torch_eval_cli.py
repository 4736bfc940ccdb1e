"""The port's eval entry points, ``test_torch.py`` and
``test_registration_metric_torch.py``, against the JAX package's
``test.py`` and ``test_registration_metric.py``: one synthetic KITTI-layout
tree, one checkpoint (written by the JAX package), float64 on both sides.

The JAX CLIs run in one CPU subprocess (``--platform cpu``), one after the
other, with recording hooks on the metric functions they call, so their
per-pair numbers and aggregates come back unrounded; the port's run in this
process on ``--device cpu`` meanwhile. Both must print the same lines
(``[timing]`` aside), give every pair the same status, and the same
per-pair numbers and aggregates to 1e-8: with the mdgat net in pose and
non-pose mode, with the superglue and raw nets, and from the ``.pth`` and
the ``.npz`` of the weights alike. ``--visualize true`` raises the open3d
ImportError (open3d is not installed), and a missing checkpoint warns and
runs to its end.

The checkpoint is a random init with a descriptor path that carries the
FPFH descriptor through (so that the untrained model matches, and pairs
pass and fail the pose gate) and small random GNN updates on top of it.
"""

import contextlib
import io
import json
import math
import os
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch

from mdgat_tpu.core.checkpoint import save_checkpoint, save_pth_checkpoint
from mdgat_tpu.core.config import test_defaults as jax_eval_defaults
from mdgat_tpu.models import MDGAT as JaxMDGAT

import test_registration_metric_torch
import test_torch
from mdgat_tpu_torch.data.synthetic import write_synthetic_kitti

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-8
SIZE = ["--batch_size", "8", "--max_keypoints", "64",
        "--compute_dtype", "float64"]
JAX_ONLY = ["--platform", "cpu", "--data_parallel", "1",
            "--shard_map", "false"]

# Runs a list of JAX eval CLIs in one process. Each run's stdout, and what
# the metric functions it calls returned (per pair, and the aggregates),
# go to a JSON file.
_JAX_RUNNER = r'''
import contextlib, io, json, runpy, sys
import mdgat_tpu.eval as E
import mdgat_tpu.eval.metrics as M

rec = {}
orig_update, orig_summary = (M.TestEvalAccumulator.update_batch,
                             M.TestEvalAccumulator.summary)
orig_reg, orig_reg_summary = E.registration_batch_metrics, E.registration_summary

def pm_of(pm):
    return None if pm is None else {k: pm[k] for k in
        ("inlier", "inlier_ratio", "trans_error", "rot_error")}

def update_batch(self, *a, **k):
    res = orig_update(self, *a, **k)
    rec["pairs"] += [dict(status=s, mm=mm, pm=pm_of(pm)) for s, mm, pm in res]
    return res

def summary(self):
    rec["summary"] = orig_summary(self)
    return rec["summary"]

def reg(*a, **k):
    res = orig_reg(*a, **k)
    rec["pairs"] += [dict(mm=mm, rte=rte, rre=rre) for mm, rte, rre in res]
    return res

def reg_summary(meters):
    rec["summary"] = orig_reg_summary(meters)
    return rec["summary"]

M.TestEvalAccumulator.update_batch = update_batch
M.TestEvalAccumulator.summary = summary
E.registration_batch_metrics = reg
E.registration_summary = reg_summary

spec, result = sys.argv[1], sys.argv[2]
runs = json.load(open(spec))
out = {}
for name, (script, argv) in runs.items():
    rec.clear()
    rec["pairs"] = []
    buf = io.StringIO()
    sys.argv = [script] + argv
    with contextlib.redirect_stdout(buf):
        runpy.run_path(script, run_name="__main__")
    rec["stdout"] = buf.getvalue()
    out[name] = dict(rec)
json.dump(out, open(result, "w"),
          default=lambda o: o.item() if hasattr(o, "item") else str(o))
'''


def _checkpoint(base, L):
    """Random init, then: the descriptor encoder passes the normalised FPFH
    descriptor through (identity into its first 33 channels, centred by the
    last layer), the keypoint encoder's and every GNN layer's last conv
    scaled down, and the final projection about 18 x identity, so that
    corresponding keypoints score high."""
    cfg = jax_eval_defaults(L=L, param_dtype="float64",
                            compute_dtype="float64")
    params, bn_state = JaxMDGAT(cfg).init(jax.random.PRNGKey(5))
    params = jax.tree.map(lambda a: np.array(a, np.float64), params)
    bn_state = jax.tree.map(np.asarray, bn_state)
    last = params["kenc"]["mlp"][-1]["lin"]
    last["w"], last["b"] = last["w"] * 0.03, last["b"] * 0.03
    for layer in params["gnn"]:
        layer["mlp"][-1]["lin"]["w"] *= 0.1
    denc = params["denc"]["mlp"]
    for i, layer in enumerate(denc):
        w = np.zeros_like(layer["lin"]["w"])
        w[:33, :33] = np.eye(33) - (1.0 / 33 if i == len(denc) - 1 else 0.0)
        layer["lin"]["w"], layer["lin"]["b"] = w, np.zeros_like(layer["lin"]["b"])
    w = 0.01 * params["final_proj"]["w"]
    w[:33, :33] += 18.0 * np.eye(33)
    params["final_proj"]["w"] = w
    pth, npz = str(base / f"ck{L}.pth"), str(base / f"ck{L}.npz")
    save_pth_checkpoint(pth, params, bn_state, cfg, epoch=1, lr=1e-4,
                        loss=1.0, dtype=np.float64)
    save_checkpoint(npz, params, bn_state, epoch=1, lr=1e-4, loss=1.0)
    return pth, npz


def _port(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main(argv)
    return dict(result=result, stdout=buf.getvalue())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("eval_cli")
    root = str(base / "kd")
    kp_dir = write_synthetic_kitti(root, seqs=(10,), frames_per_seq=6,
                                   pairs_per_seq=30, n_points=100, seed=3)
    data = ["--train_path", root, "--keypoints_path", kp_dir, "--txt_path",
            os.path.join(root, "preprocess-random-full")]
    pth2, npz2 = _checkpoint(base, 2)
    pth9, _ = _checkpoint(base, 9)          # --net raw forces L = 9
    test_py = os.path.join(REPO, "test.py")
    reg_py = os.path.join(REPO, "test_registration_metric.py")
    mdgat = [*data, *SIZE, "--l", "2", "--resume_model", pth2]
    # 30 pairs: three batches of 8 and a tail of 6 (padded, trimmed)
    argvs = {
        "test": (test_py, mdgat),
        "test_nopose": (test_py, mdgat + ["--calculate_pose", "false"]),
        "test_superglue": (test_py, mdgat + ["--net", "superglue"]),
        "test_raw": (test_py, [*data, *SIZE, "--net", "raw",
                               "--resume_model", pth9]),
        "reg": (reg_py, mdgat),
        "reg_nopose": (reg_py, mdgat + ["--calculate_pose", "false",
                                        "--max_pairs", "16"]),
    }
    spec, result = str(base / "runs.json"), str(base / "jax.json")
    with open(spec, "w") as f:
        json.dump({k: (s, a + JAX_ONLY) for k, (s, a) in argvs.items()}, f)
    runner = str(base / "jax_runner.py")
    with open(runner, "w") as f:
        f.write(_JAX_RUNNER)
    proc = subprocess.Popen(
        [sys.executable, runner, spec, result], cwd=str(base),
        env=dict(os.environ, JAX_PLATFORMS="cpu",
                 PYTHONPATH=os.pathsep.join(
                     [REPO, os.environ.get("PYTHONPATH", "")])),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    out = {"port": {}}
    try:
        cpu = ["--device", "cpu"]
        for name, (script, argv) in argvs.items():
            main = (test_torch.main if script == test_py
                    else test_registration_metric_torch.main)
            out["port"][name] = _port(main, argv + cpu)
        out["port"]["test_npz"] = _port(
            test_torch.main, [*data, *SIZE, "--l", "2", "--resume_model",
                              npz2, "--device", "cpu"])
        out["port"]["missing"] = _port(
            test_registration_metric_torch.main,
            [*data, *SIZE, "--l", "2", "--resume_model",
             str(base / "absent.pth"), "--max_pairs", "8", "--device", "cpu"])
        out["vis_argv"] = mdgat + ["--calculate_pose", "false",
                                   "--visualize", "true", "--device", "cpu"]
    finally:
        stdout, stderr = proc.communicate(timeout=900)
    assert proc.returncode == 0, stdout[-3000:] + stderr[-3000:]
    with open(result) as f:
        out["jax"] = json.load(f)
    return out


def _close(got, want, where):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _close(got[k], want[k], f"{where}.{k}")
    elif want is None:
        assert got is None, where
    elif isinstance(want, bool):
        assert bool(got) is want, where
    elif isinstance(want, int):
        assert int(got) == want, where
    elif math.isnan(want):
        assert math.isnan(got), where
    else:
        assert abs(got - want) <= TOL * max(1.0, abs(want)), (where, got, want)


def _lines(stdout):
    return [line for line in stdout.splitlines()
            if not line.startswith("[timing]")]


NAMES = ["test", "test_nopose", "test_superglue", "test_raw", "reg",
         "reg_nopose"]


@pytest.mark.parametrize("name", NAMES)
def test_same_lines_statuses_and_numbers_as_the_jax_cli(runs, name):
    port, jax_run = runs["port"][name], runs["jax"][name]
    assert _lines(port["stdout"]) == _lines(jax_run["stdout"])
    pairs = port["result"]["pairs"]
    assert len(pairs) == len(jax_run["pairs"]) > 0
    for i, (got, want) in enumerate(zip(pairs, jax_run["pairs"])):
        _close(got["mm"], want["mm"], f"pair {i} mm")
        if name.startswith("test"):
            assert got["status"] == want["status"], i
            pm = (None if got["pm"] is None else
                  {k: got["pm"][k] for k in want["pm"]})
            _close(pm, want["pm"], f"pair {i} pm")
        else:
            _close(got["rte"], want["rte"], f"pair {i} rte")
            _close(got["rre"], want["rre"], f"pair {i} rre")
    _close(port["result"]["summary"], jax_run["summary"], "summary")
    # the pair lines printed are the records' lines, in order
    body = [line for line in port["stdout"].splitlines()
            if line.startswith("idx") or line == "registration fail"]
    assert body == [p["line"] for p in pairs if p["line"] is not None]


def test_the_runs_cover_the_protocol(runs):
    """Pose mode passes and fails pairs; non-pose mode prints NaN
    aggregates by design; 30 pairs are three batches and a tail, and
    ``--max_pairs 16`` stops after two batches."""
    port = runs["port"]
    statuses = {p["status"] for p in port["test"]["result"]["pairs"]}
    assert {"ok", "pose_fail"} <= statuses
    assert port["test"]["result"]["n_pairs"] == 30
    assert port["test"]["result"]["n_batches"] == 4
    assert {p["status"] for p in port["test_nopose"]["result"]["pairs"]} \
        <= {"ok_nopose", "too_few", "banned"}
    assert math.isnan(port["test_nopose"]["result"]["summary"]["precision"])
    assert port["reg_nopose"]["result"]["n_pairs"] == 16
    rr = port["reg"]["result"]["summary"]["RR"]
    assert 0 < rr < 1
    for name in ("test", "reg"):
        assert "pairs/s" in port[name]["stdout"].splitlines()[-2]


def test_npz_and_pth_give_the_same_run(runs):
    a, b = runs["port"]["test"], runs["port"]["test_npz"]
    assert _lines(a["stdout"])[1:] == _lines(b["stdout"])[1:]  # "Resume from"
    for x, y in zip(a["result"]["pairs"], b["result"]["pairs"]):
        np.testing.assert_array_equal(x["matches0"], y["matches0"])
    _close(b["result"]["summary"], a["result"]["summary"], "summary")


def test_nets_run_all_dense(runs):
    """superglue and raw: every layer dense (raw at L = 9, as the JAX
    package forces it); their matches differ from mdgat's top-k layers on
    some pair."""
    from mdgat_tpu_torch.cli import build_parser, config_from_args
    for net, layers in (("superglue", 4), ("raw", 18)):
        args = build_parser("test").parse_args(["--net", net, "--l", "2"])
        cfg = config_from_args(args, "test")
        assert cfg.layer_k_schedule(128) == [None] * layers
    assert any(
        not np.array_equal(x["matches0"], y["matches0"])
        for x, y in zip(runs["port"]["test"]["result"]["pairs"],
                        runs["port"]["test_raw"]["result"]["pairs"]))


def test_visualize_raises_the_open3d_import_error(runs, monkeypatch):
    monkeypatch.setitem(sys.modules, "open3d", None)   # absent, as here
    with pytest.raises(ImportError, match="open3d is required"):
        _port(test_torch.main, runs["vis_argv"])


def test_missing_checkpoint_warns_and_finishes(runs):
    run = runs["port"]["missing"]
    assert run["stdout"].startswith("[warn] checkpoint not found")
    assert run["result"]["n_pairs"] == 8
    assert "repeatibility, inlier, RR" in run["stdout"]


def test_absent_cuda_device_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (test_torch.main, test_registration_metric_torch.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--keypoints_path", str(tmp_path), "--l", "2"])
