"""The training entry point of the port, ``train_torch.py``, against the JAX
package's ``train.py``: parser defaults, and the slice as a whole. Both entry
points start from one checkpoint (written by the JAX package's
``save_pth_checkpoint``) on one synthetic KITTI-layout tree at float64 and a
small size, and must log the same ``Train/epoch_loss`` and ``Train/val_loss``
and save the same parameters; resume semantics, checkpoint naming, the
``.npz`` resume and ``--loss_kernel true`` are held on the way.
"""

import json
import os
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch

from mdgat_tpu import cli as jax_cli
from mdgat_tpu.core.checkpoint import save_checkpoint, save_pth_checkpoint
from mdgat_tpu.core.config import train_defaults as jax_train_defaults
from mdgat_tpu.models import MDGAT as JaxMDGAT

import train_torch
from mdgat_tpu_torch import cli
from mdgat_tpu_torch.core.checkpoint import (load_npz, load_pth_state_dict,
                                             state_dict_from_numpy)
from mdgat_tpu_torch.core.config import train_defaults
from mdgat_tpu_torch.data.synthetic import write_synthetic_kitti

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT_LR, CKPT_LOSS, CKPT_EPOCH = 2e-3, 0.7, 3
SIZE = ["--l", "2", "--max_keypoints", "64", "--batch_size", "4",
        "--steps_per_epoch", "2", "--compute_dtype", "float64"]
# flags of the JAX parser that the port leaves out on purpose (cli.py)
NOT_PORTED = {"data_parallel", "use_pallas",
              "pallas_attention", "scan_gnn_pairs",
              "pallas_train_layer", "pallas_loss", "pallas_interpret",
              "shard_map", "platform", "ship_bf16"}
PORT_ONLY = {"device", "use_kernels", "train_layer", "loss_kernel",
             "dist_backend"}


@pytest.mark.parametrize("preset", ["train", "test"])
def test_parser_defaults_equal_the_jax_parsers(preset):
    got = vars(cli.build_parser(preset).parse_args([]))
    want = vars(jax_cli.build_parser(preset).parse_args([]))
    assert set(want) - set(got) == NOT_PORTED - ({"ship_bf16"} if preset == "train" else set())
    assert set(got) - set(want) == PORT_ONLY
    for key in set(got) & set(want):
        assert got[key] == want[key], key
        assert type(got[key]) is type(want[key]), key
    assert got["device"] == "cuda" and got["loss_kernel"] is False
    assert got["use_kernels"] is True and got["train_layer"] is True
    # the same strings parse to the same values
    argv = ["--k", "[64, None]", "--mutual_check", "true", "--l", "3",
            "--learning_rate", "0.01", "--local_rank", "0", "1",
            "--memory_is_enough", "false", "--resume", "yes"]
    got = vars(cli.build_parser(preset).parse_args(argv))
    want = vars(jax_cli.build_parser(preset).parse_args(argv))
    for key in set(got) & set(want):
        assert got[key] == want[key], key
    pcfg = cli.config_from_args(cli.build_parser(preset).parse_args(argv), preset)
    jcfg = jax_cli.config_from_args(
        jax_cli.build_parser(preset).parse_args(argv), preset)
    for field in ("k", "L", "mutual_check", "learning_rate", "memory_is_enough",
                  "resume", "batch_size", "max_keypoints", "ensure_kpts_num",
                  "loss_method", "param_dtype", "compute_dtype"):
        assert getattr(pcfg, field) == getattr(jcfg, field), field
    assert pcfg.run_dir("x") == jcfg.run_dir("x")
    assert pcfg.loss_kernel is False


@pytest.mark.parametrize("argv", [
    ["--net", "superglue"], ["--net", "raw"], ["--descriptor", "pointnet"],
    ["--descriptor", "FPFH_only"], ["--descriptor", "FPFH_gloabal"],
    ["--descriptor", "pointnetmsg"],
    ["--descriptor", "pointnetmsg", "--train_step", "1"],
    ["--descriptor", "pointnet", "--net", "superglue", "--train_step", "2"]])
def test_baseline_nets_and_descriptors_build(argv):
    """The two baseline nets build, as the JAX package's config does (raw:
    k=None and L=9, train.py:130-132), each with an all-dense schedule;
    every descriptor mode builds, with the JAX package's descriptor,
    train_step and run directory (``train_step{n}`` for the pointnet
    modes), and a model of it."""
    from mdgat_tpu_torch.models.factory import build_model
    for preset in ("train", "test"):
        args = cli.build_parser(preset).parse_args(argv)
        cfg = cli.config_from_args(args, preset)
        jcfg = jax_cli.config_from_args(
            jax_cli.build_parser(preset).parse_args(argv), preset)
        assert (cfg.net, cfg.k, cfg.L) == (jcfg.net, jcfg.k, jcfg.L)
        assert (cfg.descriptor, cfg.train_step) == (jcfg.descriptor,
                                                    jcfg.train_step)
        assert cfg.run_dir("x") == jcfg.run_dir("x")
        if "--net" in argv:
            assert cfg.layer_k_schedule(512) == [None] * (2 * cfg.L)
        if cfg.descriptor.startswith("pointnet"):
            assert f"/train_step{cfg.train_step}/" in cfg.run_dir("x")
    assert build_model(cfg.replace(L=1)).config.descriptor == cfg.descriptor


def test_pointnetmsg_entry_points_run_on_the_cpu(tmp_path, monkeypatch):
    """``train_torch.main --descriptor pointnetmsg --synthetic true`` writes
    the raw clouds (4 x 300 points a frame, as the JAX package's CLI) and
    trains; ``test_torch.main`` and ``test_registration_metric_torch.main``
    evaluate its checkpoint, the clouds flowing through ``EvalPipeline``."""
    import test_registration_metric_torch
    import test_torch
    monkeypatch.chdir(tmp_path)
    kd = str(tmp_path / "kd")
    small = ["--synthetic", "true", "--train_path", kd, "--device", "cpu",
             "--descriptor", "pointnetmsg", "--l", "1", "--batch_size", "4"]
    summary = train_torch.main(small + [
        "--max_keypoints", "64", "--epoch", "1", "--steps_per_epoch", "2",
        "--model_out_path", str(tmp_path / "ck")])
    assert summary["steps"] == [2] and np.isfinite(summary["epoch_loss"]).all()
    cloud = np.fromfile(os.path.join(kd, "kitti_randomsample_16384_n8", "10",
                                     "000000.bin"), np.float32)
    assert cloud.shape == (4 * 300 * 8,)
    ckpt = summary["checkpoints"][-1]
    assert "/train_step3/" in ckpt
    for main in (test_torch.main, test_registration_metric_torch.main):
        out = main(small + ["--resume_model", ckpt, "--max_pairs", "8",
                            "--max_keypoints", "64", "--ensure_kpts_num",
                            "true"])
        assert out["n_pairs"] == 8


def test_missing_keypoints_without_synthetic_exits(tmp_path):
    args = cli.build_parser("train").parse_args(
        ["--keypoints_path", str(tmp_path / "nope")])
    with pytest.raises(SystemExit, match="keypoints_path not found"):
        cli.maybe_generate_synthetic(cli.config_from_args(args, "train"), args)


def test_cuda_device_that_is_absent_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_torch.main(["--synthetic", "true", "--train_path",
                          str(tmp_path / "kd"), "--max_keypoints", "64",
                          "--model_out_path", str(tmp_path / "ck")])


# ---------------------------------------------------------------------------
# --trace_dir and --debug_nans
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_tree(tmp_path_factory):
    """A small synthetic tree and the flags of a one-step CPU run on it."""
    root = str(tmp_path_factory.mktemp("flags") / "kd")
    kp_dir = write_synthetic_kitti(root, seqs=(0, 2, 3, 4, 5, 6, 7, 9, 10),
                                   frames_per_seq=3, pairs_per_seq=2,
                                   n_points=80, seed=4)
    return ["--train_path", root, "--keypoints_path", kp_dir, "--txt_path",
            os.path.join(root, "preprocess-random-full"), "--device", "cpu",
            "--l", "1", "--max_keypoints", "64", "--batch_size", "2",
            "--epoch", "1", "--steps_per_epoch", "1", "--max_pairs", "2"]


def test_trace_dir_writes_a_trace(small_tree, tmp_path, monkeypatch):
    """``--trace_dir`` on a one-step CPU run of ``train_torch.main``: the
    profiler's Chrome trace of the run, named by rank, is in the directory
    when ``main`` returns, and the profiler is off again."""
    monkeypatch.chdir(tmp_path)
    trace = tmp_path / "trace"
    summary = train_torch.main(small_tree + [
        "--model_out_path", str(tmp_path / "ck"), "--trace_dir", str(trace)])
    assert summary["steps"] == [1]
    assert os.listdir(trace) == ["trace_rank0.json"]
    with open(trace / "trace_rank0.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names), sorted(names)[:20]
    assert not torch.autograd._profiler_enabled()


def _plant_nan(monkeypatch):
    """Every prepared batch gets a NaN in its first pair's descriptors."""
    from mdgat_tpu_torch.data import pipeline
    from mdgat_tpu_torch.eval import runner
    prepare = pipeline.prepare_batch

    def planted(*args, **kw):
        out = prepare(*args, **kw)
        out["descriptors0"][0, 0, 0] = float("nan")
        return out
    monkeypatch.setattr(pipeline, "prepare_batch", planted)
    monkeypatch.setattr(runner, "prepare_batch", planted)


@pytest.mark.parametrize("entry", ["train_torch", "test_torch",
                                   "test_registration_metric_torch"])
def test_debug_nans_raises_on_a_planted_nan(entry, small_tree, tmp_path,
                                            monkeypatch):
    """A NaN planted in a batch's descriptors: with ``--debug_nans true``
    the entry point raises ``FloatingPointError`` (what ``jax_debug_nans``
    raises), and anomaly mode is off again afterwards; without the flag
    the same run goes through."""
    import importlib
    main = importlib.import_module(entry).main
    monkeypatch.chdir(tmp_path)
    _plant_nan(monkeypatch)
    argv = small_tree + ["--model_out_path", str(tmp_path / "ck")]
    with pytest.raises(FloatingPointError, match="debug_nans"):
        main(argv + ["--debug_nans", "true"])
    assert not torch.is_anomaly_enabled()
    main(argv)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

def _scalars(log_root):
    found = [os.path.join(base, "scalars.jsonl")
             for base, _, names in os.walk(log_root) if "scalars.jsonl" in names]
    assert len(found) == 1, found
    with open(found[0]) as f:
        rows = [json.loads(line) for line in f]
    return {(r["tag"], r["step"]): r["value"] for r in rows}


def _checkpoints(root, suffix):
    return sorted(os.path.join(base, n) for base, _, names in os.walk(root)
                  for n in names if n.endswith(suffix))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One tree, one checkpoint, then: ``train.py`` (a subprocess on the CPU)
    and ``train_torch.main`` resumed from the ``.pth`` with the plain loss,
    with ``--loss_kernel true``, and from the ``.npz`` of the same weights;
    each in its own working directory, which receives ``./logs``."""
    base = tmp_path_factory.mktemp("cli")
    root = str(base / "kd")
    kp_dir = write_synthetic_kitti(root, seqs=(0, 2, 3, 4, 5, 6, 7, 9, 10),
                                   frames_per_seq=5, pairs_per_seq=6,
                                   n_points=80, seed=2)
    data = ["--train_path", root, "--keypoints_path", kp_dir, "--txt_path",
            os.path.join(root, "preprocess-random-full")]

    jcfg = jax_train_defaults(L=2, param_dtype="float64",
                              compute_dtype="float64")
    params, bn_state = JaxMDGAT(jcfg).init(jax.random.PRNGKey(5))
    params = jax.tree.map(np.asarray, params)
    bn_state = jax.tree.map(np.asarray, bn_state)
    pth, npz = str(base / "start.pth"), str(base / "start.npz")
    save_pth_checkpoint(pth, params, bn_state, jcfg, epoch=CKPT_EPOCH,
                        lr=CKPT_LR, loss=CKPT_LOSS, dtype=np.float64)
    save_checkpoint(npz, params, bn_state, epoch=CKPT_EPOCH, lr=CKPT_LR,
                    loss=CKPT_LOSS)

    def resume(path):
        # the CLI learning rate is a probe: resume must not use it
        return ["--epoch", "1", "--resume", "true", "--resume_model", path,
                "--learning_rate", "0.5"]

    out = {"start": state_dict_from_numpy(params, bn_state, train_defaults(L=2))}
    cwd = base / "jax"
    cwd.mkdir()
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "train.py"), *data, *SIZE,
         *resume(pth), "--model_out_path", str(cwd / "ck"), "--platform",
         "cpu", "--data_parallel", "1", "--shard_map", "false"],
        env=dict(os.environ, JAX_PLATFORMS="cpu"), cwd=str(cwd),
        capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    out["jax"] = dict(cwd=cwd, stdout=r.stdout)

    old = os.getcwd()
    for name, argv in (("port", resume(pth)),
                       ("port_loss_kernel", resume(pth) + ["--loss_kernel", "true"]),
                       ("port_npz", resume(npz)),
                       ("port_fresh", ["--epoch", "2", "--learning_rate", "1e-3"])):
        cwd = base / name
        cwd.mkdir()
        os.chdir(cwd)
        try:
            summary = train_torch.main([*data, *SIZE, *argv, "--device", "cpu",
                                        "--model_out_path", str(cwd / "ck")])
        finally:
            os.chdir(old)
        out[name] = dict(cwd=cwd, summary=summary)
    return out


def test_both_entry_points_log_the_same_scalars(runs):
    """``Train/epoch_loss`` and ``Train/val_loss`` of epoch 1 to 1e-8
    (float64 on both sides; two train steps and one validation step)."""
    want = _scalars(runs["jax"]["cwd"] / "logs")
    got = _scalars(runs["port"]["cwd"] / "logs")
    assert sorted(got) == sorted(want) == [("Train/epoch_loss", 1),
                                           ("Train/val_loss", 1)]
    for key, value in want.items():
        assert np.isfinite(value)
        np.testing.assert_allclose(got[key], value, rtol=1e-8, atol=1e-8,
                                   err_msg=str(key))
    summary = runs["port"]["summary"]
    assert summary["steps"] == [2]
    assert summary["epoch_loss"] == [got[("Train/epoch_loss", 1)]]
    assert summary["val_loss"] == [got[("Train/val_loss", 1)]]
    assert set(summary["timer"]) == {"prepare", "train_step", "validation"}
    assert summary["timer"]["train_step"]["count"] == 2
    assert summary["timer"]["validation"]["count"] == 1


def test_both_entry_points_save_the_same_parameters(runs):
    """The checkpoint each wrote after the epoch: every parameter and running
    statistic to 1e-8 (at float64 the entries whose gradient is zero in exact
    arithmetic move by lr * 1e-9 at most, see the train-step tests), and
    they did move from the start."""
    (jck,) = _checkpoints(runs["jax"]["cwd"] / "ck", ".npz")
    (pck,) = _checkpoints(runs["port"]["cwd"] / "ck", ".pth")
    params, bn_state, meta = load_npz(jck)
    want = state_dict_from_numpy(params, bn_state, train_defaults(L=2))
    got = load_pth_state_dict(pck)
    assert sorted(got) == sorted(want)
    moved = 0
    for key, w in want.items():
        if key.endswith("num_batches_tracked"):
            assert int(got[key]) == 4                 # 2 steps x 2 clouds
            continue
        assert got[key].dtype == torch.float64
        np.testing.assert_allclose(got[key].numpy(), w.numpy(), rtol=0,
                                   atol=1e-8, err_msg=key)
        moved += int((got[key] - runs["start"][key]).abs().max() > 1e-6)
    assert moved > 0.6 * len(want)      # zero-gradient biases stay put
    ckpt = torch.load(pck, map_location="cpu", weights_only=True)
    assert ckpt["epoch"] == meta["epoch"] == 1
    assert ckpt["lr_schedule"] == meta["lr_schedule"] == CKPT_LR
    np.testing.assert_allclose(ckpt["loss"], meta["loss"], rtol=1e-8)
    assert all(k.startswith("module.") for k in ckpt["net"])
    assert len(ckpt["optimizer"]["state"]) > 30       # moments are saved


def test_resume_takes_the_checkpointed_lr_and_resets_best(runs):
    """``--learning_rate 0.5`` on the command line must not be used: Adam
    moves an entry by at most about lr a step, so two steps at the
    checkpointed 2e-3 stay under 5e-3 where 0.5 would move them by ~1. Best
    resets to 1.0, not to the checkpoint's 0.7 and not to 1e6: the epoch's
    checkpoint is named best exactly when its validation loss is at most
    1 + 1e-5."""
    (pck,) = _checkpoints(runs["port"]["cwd"] / "ck", ".pth")
    got = load_pth_state_dict(pck)
    step = max(float((got[k] - v).abs().max()) for k, v in runs["start"].items()
               if "running_" not in k and "num_batches" not in k)
    assert 1e-4 < step < 2.5 * 2 * CKPT_LR
    val = runs["port"]["summary"]["val_loss"][0]
    name = os.path.basename(pck)
    if val <= 1.0 + 1e-5:
        assert name == f"best_model_epoch_1(val_loss{val}).pth"
    else:
        assert name == "model_epoch_1.pth"
    assert val > CKPT_LOSS                    # best did not start at 0.7
    (jck,) = _checkpoints(runs["jax"]["cwd"] / "ck", ".npz")
    assert os.path.basename(jck)[:-4].split("(")[0] == name[:-4].split("(")[0]
    assert f"lr {CKPT_LR}" in runs["jax"]["stdout"]


def test_checkpoint_names_follow_the_best_rule(runs):
    """A fresh run of two epochs: epoch 1 is always best (best starts at
    1e6); epoch 2 is best exactly when its validation loss is at most
    epoch 1's + 1e-5. Fresh runs use the command line's learning rate."""
    summary = runs["port_fresh"]["summary"]
    v1, v2 = summary["val_loss"]
    names = [os.path.basename(p) for p in summary["checkpoints"]]
    assert names[0] == f"best_model_epoch_1(val_loss{v1}).pth"
    assert names[1] == (f"best_model_epoch_2(val_loss{v2}).pth"
                        if v2 <= v1 + 1e-5 else "model_epoch_2.pth")
    assert all(os.path.isfile(p) for p in summary["checkpoints"])
    ckpt = torch.load(summary["checkpoints"][1], map_location="cpu",
                      weights_only=True)
    assert ckpt["lr_schedule"] == 1e-3 and ckpt["epoch"] == 2
    scalars = _scalars(runs["port_fresh"]["cwd"] / "logs")
    assert sorted(scalars) == [("Train/epoch_loss", 1), ("Train/epoch_loss", 2),
                               ("Train/val_loss", 1), ("Train/val_loss", 2)]
    assert summary["epoch_loss"][1] < summary["epoch_loss"][0]


@pytest.mark.parametrize("other", ["port_loss_kernel", "port_npz"])
def test_loss_kernel_and_npz_resume_give_the_same_run(runs, other):
    """``--loss_kernel true`` (on the CPU: the margin kernels' plain twins)
    and a resume from the JAX package's ``.npz`` of the same weights: the
    same scalars and saved parameters as the ``.pth`` run with the plain
    loss, to 1e-10."""
    want, got = runs["port"]["summary"], runs[other]["summary"]
    for key in ("epoch_loss", "val_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-10, atol=1e-10)
    (a,) = _checkpoints(runs[other]["cwd"] / "ck", ".pth")
    (b,) = _checkpoints(runs["port"]["cwd"] / "ck", ".pth")
    sa, sb = load_pth_state_dict(a), load_pth_state_dict(b)
    for key, w in sb.items():
        np.testing.assert_allclose(sa[key].numpy(), w.numpy(), rtol=0,
                                   atol=1e-10, err_msg=key)
    flag = runs[other]["summary"]["state"].model.config.loss_kernel
    assert flag is (other == "port_loss_kernel")
