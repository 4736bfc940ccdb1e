"""The port's context-parallel (``seq``) axis against the JAX package's on
the CPU.

* The rank layout: ``process_batch_rows(B, seq=S)``, ``seq_columns`` and
  ``shard_batch(..., seq_block=...)`` against the JAX package's
  ``(data, seq)`` mesh shardings (``batch_pspec`` / ``batch_sharding`` with
  ``shard_seq=True``, the device grid rows major), and the refusals.
* ``parallel.all_gather`` as two ranks: the gathered tensors and the
  backward (the cotangents summed over the members, this member's block
  kept) against their closed form.
* The training step as gloo ranks (``torch_parallel_worker.py``, no JAX) in
  a 1 x 2 and a 2 x 2 (data x seq) layout at float64: the plain path
  against the JAX package's ``make_shard_map_train_step`` on
  ``make_mesh(data=1, seq=2)`` / ``(2, 2)`` of the virtual CPU devices,
  and the default route (the whole-layer kernels' twin) against the port's
  one-process step; loss and grad_norm of two steps, every parameter and
  BatchNorm running statistic after them, to 1e-9. A ragged batch whose
  second cloud has no valid keypoint in the second seq block. Seq eval
  against ``make_shard_map_eval_step``: equal matches, scores to 1e-9.
* The three entry points as two ranks with ``--seq_parallel 2``.
"""

import contextlib
import io
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from mdgat_tpu.core.config import train_defaults as jax_train_defaults
from mdgat_tpu.models import MDGAT as JaxMDGAT
from mdgat_tpu.parallel import make_mesh
from mdgat_tpu.parallel import replicate as jax_replicate
from mdgat_tpu.parallel import shard_batch as jax_shard_batch
from mdgat_tpu.parallel.mesh import batch_pspec, batch_sharding
from mdgat_tpu.parallel.smap import (make_shard_map_eval_step,
                                     make_shard_map_train_step)
from mdgat_tpu.train.loop import TrainState as JaxTrainState

import test_registration_metric_torch
import test_torch
import train_torch
from mdgat_tpu_torch import cli
from mdgat_tpu_torch.core.checkpoint import (load_pth_state_dict,
                                             state_dict_from_numpy)
from mdgat_tpu_torch.core.config import test_defaults as eval_defaults
from mdgat_tpu_torch.core.config import train_defaults
from mdgat_tpu_torch.data.pipeline import (collate_pairs, model_inputs,
                                           prepare_batch)
from mdgat_tpu_torch.data.synthetic import (make_synthetic_pair,
                                            write_synthetic_kitti)
from mdgat_tpu_torch.parallel import mesh as port_mesh
from mdgat_tpu_torch.parallel import multihost, shard_batch

from test_torch_parallel import LR, STEPS, F64, _one_process, _run_ranks
from test_torch_parallel_cli import (SIZE, _aggregates, _in_process,
                                     _pair_lines, _ranks, _wait)
from test_torch_eval_cli import _checkpoint
from test_torch_train_step import TINY, _batch, _weights
from torch_parallel_worker import gather_blocks

JAX_CFG = dict(TINY, loss_method="gap_loss", **F64)


# ---------------------------------------------------------------------------
# the rank layout
# ---------------------------------------------------------------------------

@pytest.fixture
def ranks(monkeypatch):
    def set_(rank, world):
        monkeypatch.setattr(multihost, "process_index", lambda: rank)
        monkeypatch.setattr(multihost, "process_count", lambda: world)
    return set_


def _as_slice(idx, n):
    return slice(idx.start or 0, n if idx.stop is None else idx.stop)


@pytest.mark.parametrize("data, seq", [(1, 2), (2, 2), (1, 4), (2, 4),
                                       (4, 2), (3, 1)])
def test_layout_equals_the_jax_mesh(ranks, data, seq):
    """Rank ``d * S + s`` holds the rows and the keypoint columns that the
    JAX package's mesh places on device ``(d, s)``."""
    b, n = 12, 48
    mesh = make_mesh(data=data, seq=seq, devices=jax.devices()[:data * seq])
    rows_map = batch_sharding(mesh, "keypoints0", True).devices_indices_map(
        (b, n, 3))
    for rank, device in enumerate(mesh.devices.flat):
        ranks(rank, data * seq)
        want_rows, want_cols = rows_map[device][:2]
        assert multihost.mesh_coords(seq) == (data, seq, rank // seq,
                                              rank % seq)
        assert multihost.process_batch_rows(b, seq) == _as_slice(want_rows, b)
        assert multihost.seq_columns(n, seq) == _as_slice(want_cols, n)


def test_shard_batch_keys_equal_the_jax_specs():
    """The keys split along the keypoint axis are those the JAX package
    shards over ``seq``; every other key (the raw clouds, T_gt, rep) is
    whole, and each sliced array equals the JAX shard of device (0, 1)."""
    keys = ("keypoints0", "keypoints1", "descriptors0", "descriptors1",
            "scores0", "scores1", "gt_matches0", "gt_matches1", "mask0",
            "mask1", "kpts0_world", "kpts1_world", "T_gt", "rep", "cloud0",
            "cloud1")
    seq_keys = {k for k in keys if "seq" in tuple(batch_pspec(k, True))}
    assert seq_keys == set(port_mesh.SEQ_KEYS)
    rng = np.random.default_rng(0)
    batch = {k: rng.normal(size=(4, 8, 2)) for k in keys}
    mesh = make_mesh(data=2, seq=2, devices=jax.devices()[:4])
    sharded = jax_shard_batch(batch, mesh, shard_seq=True)
    got = shard_batch(batch, slice(0, 2), seq_block=(1, 2))
    device = mesh.devices[0, 1]
    for k in keys:
        want = [s.data for s in sharded[k].addressable_shards
                if s.device == device][0]
        np.testing.assert_array_equal(got[k], np.asarray(want), k)
    t = shard_batch({"mask0": torch.ones(4, 8, dtype=torch.bool)},
                    seq_block=(0, 2))["mask0"]
    assert t.shape == (4, 4) and t.is_contiguous()


def test_uneven_layouts_are_refused(ranks):
    ranks(0, 4)
    with pytest.raises(ValueError, match="does not divide the 4 ranks"):
        multihost.mesh_coords(3)
    with pytest.raises(ValueError, match="not a multiple of the 2 data rows"):
        multihost.process_batch_rows(3, seq=2)
    with pytest.raises(ValueError, match="--max_keypoints"):
        multihost.seq_columns(50, 4)
    ranks(0, 1)
    with pytest.raises(ValueError, match="does not divide the 1 ranks"):
        port_mesh.data_parallel_group("cpu", 2)
    assert port_mesh.data_parallel_group("cpu", 1) is None
    with pytest.raises(ValueError, match="--max_keypoints"):
        cli.check_seq_layout(train_defaults(max_keypoints=50, seq_parallel=4))
    with pytest.raises(ValueError, match="128 of the variable-size buckets"):
        cli.check_seq_layout(eval_defaults(seq_parallel=3))
    with pytest.raises(ValueError, match="FPFH_gloabal"):
        cli.check_seq_layout(train_defaults(seq_parallel=2,
                                            descriptor="FPFH_gloabal"))
    cli.check_seq_layout(eval_defaults(seq_parallel=4))
    cli.check_seq_layout(train_defaults(max_keypoints=48, seq_parallel=3))


# ---------------------------------------------------------------------------
# the steps as ranks
# ---------------------------------------------------------------------------

GATHER = dict(shapes=[(2, 3, 5), (2, 4, 5)], seed=70)


def _ragged_batch():
    """Batch 4 x 48 whose second cloud has at most 24 valid keypoints in
    every pair: the second seq block of cloud 1 is all padding."""
    rng = np.random.default_rng(1500)
    pairs = []
    for n0, n1 in [(40, 20), (30, 24), (48, 12), (33, 18)]:
        p = make_synthetic_pair(rng, n_points=n0, overlap=0.8, jitter=0.02,
                                desc_noise=0.02)
        for key in ("kp1", "desc1", "score1"):
            p[key] = p[key][:n1]
        pairs.append(p)
    batch = model_inputs(prepare_batch(
        collate_pairs(pairs, dtype=np.float64, bucket=48), 0.5, False, "cpu",
        torch.float64, torch.float64))
    assert batch["mask1"].shape == (4, 48) and not batch["mask1"][:, 24:].any()
    return batch


def _jax_state(params, bn_state):
    tx = optax.adam(LR)
    jp = jax.tree.map(jnp.asarray, params)
    return JaxMDGAT(jax_train_defaults(**JAX_CFG)), tx, JaxTrainState(
        jp, jax.tree.map(jnp.asarray, bn_state), tx.init(jp),
        jnp.zeros((), jnp.int32))


def _jax_seq_train(params, bn_state, batch, data, seq, pcfg):
    """The JAX package's shard_map step on a data x seq mesh, STEPS times."""
    model, tx, state = _jax_state(params, bn_state)
    mesh = make_mesh(data=data, seq=seq, devices=jax.devices()[:data * seq])
    step = make_shard_map_train_step(model, tx, mesh, donate=False)
    state = jax_replicate(state, mesh)
    jbatch = jax_shard_batch({k: v.numpy() for k, v in batch.items()}, mesh,
                             shard_seq=True)
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, jbatch)
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(metrics=metrics, state=state_dict_from_numpy(
        jax.tree.map(np.asarray, state.params),
        jax.tree.map(np.asarray, state.bn_state), pcfg))


def _jax_seq_eval(params, bn_state, batch, data, seq):
    model = JaxMDGAT(jax_train_defaults(**JAX_CFG))
    mesh = make_mesh(data=data, seq=seq, devices=jax.devices()[:data * seq])
    out = make_shard_map_eval_step(model, mesh)(
        jax_replicate(jax.tree.map(jnp.asarray, params), mesh),
        jax_replicate(jax.tree.map(jnp.asarray, bn_state), mesh),
        jax_shard_batch({k: v.numpy() for k, v in batch.items()}, mesh,
                        shard_seq=True))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def seq_runs(tmp_path_factory):
    """The runs as 1 x 2 and 2 x 2 ranks, and what each is held against."""
    params, bn_state = _weights("float64")
    batch, ragged = _batch("float64"), _ragged_batch()
    fpfh = dict(TINY, loss_method="gap_loss", **F64)
    plain = dict(fpfh, use_kernels=False)
    weights = state_dict_from_numpy(params, bn_state, train_defaults(**fpfh))
    run = lambda config, batches, **kw: dict(
        config=config, state_dict=weights, lr=LR, batches=batches, **kw)
    got, want = {}, {}
    for data, seq, extra in ((1, 2, True), (2, 2, False)):
        spec = {"plain": run(plain, [batch] * STEPS),
                "default": run(fpfh, [batch] * STEPS),
                "eval": run(fpfh, [batch], eval=True)}
        if extra:
            spec.update(ragged_plain=run(plain, [ragged] * STEPS),
                        ragged_default=run(fpfh, [ragged] * STEPS),
                        gather=dict(gather=GATHER))
        layout = f"{data}x{seq}"
        got[layout] = _run_ranks(spec, tmp_path_factory.mktemp(layout),
                                 world=data * seq, seq=seq)
        want[layout] = dict(
            plain=_jax_seq_train(params, bn_state, batch, data, seq,
                                 train_defaults(**plain)),
            eval=_jax_seq_eval(params, bn_state, batch, data, seq))
    want["default"] = _one_process(fpfh, weights, [batch] * STEPS)
    want["ragged_plain"] = _one_process(plain, weights, [ragged] * STEPS)
    want["ragged_default"] = _one_process(fpfh, weights, [ragged] * STEPS)
    return got, want


def _same_step(got, want, run):
    for g, w in zip(got["metrics"], want["metrics"]):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-9, atol=0,
                                       err_msg=key)
    assert got["metrics"][-1]["loss"] < got["metrics"][0]["loss"]
    assert sorted(got["state"]) == sorted(want["state"])
    for key, w in want["state"].items():
        if key.endswith("num_batches_tracked"):
            # the JAX package keeps no such counter
            assert "plain" in run or torch.equal(got["state"][key], w), key
            continue
        np.testing.assert_allclose(got["state"][key].numpy(), w.numpy(),
                                   rtol=1e-9, atol=1e-9, err_msg=key)


@pytest.mark.parametrize("layout, run", [
    ("1x2", "plain"), ("2x2", "plain"), ("1x2", "default"),
    ("2x2", "default"), ("1x2", "ragged_plain"), ("1x2", "ragged_default")])
def test_seq_ranks_give_the_global_batch_step(seq_runs, layout, run):
    """plain: against the JAX package's shard_map step on the same mesh;
    default and the ragged batch: against the port's one-process step.
    Every rank ends bit-equal to rank 0."""
    got, want = seq_runs
    ranks = got[layout]
    w = want[layout][run] if run == "plain" else want[run]
    _same_step(ranks[0][run], w, run)
    for r in ranks[1:]:
        assert r[run]["metrics"] == ranks[0][run]["metrics"]
        for key, t in ranks[0][run]["state"].items():
            assert torch.equal(t, r[run]["state"][key]), key


@pytest.mark.parametrize("layout", ["1x2", "2x2"])
def test_seq_eval_equals_jax(seq_runs, layout):
    """Every member returns its data row's outputs on the whole clouds:
    the JAX package's matches, and its scores and loss to 1e-9."""
    got, want = seq_runs
    ranks, jout = got[layout], want[layout]["eval"]
    seq, rows = 2, len(got[layout]) // 2
    for r in ranks:
        assert r["eval"]["metrics"][0]["matches0"].shape == (4 // rows, 48)
        assert r["eval"]["counts"] == [{"input_gather": 1,
                                        "kv_gather": 2 * TINY["L"],
                                        "tail_gather": 1}]
    for s in range(seq):
        outs = [ranks[d * seq + s]["eval"]["metrics"][0] for d in range(rows)]
        for key in ("matches0", "matches1"):
            np.testing.assert_array_equal(
                np.concatenate([o[key].numpy() for o in outs]), jout[key])
        for key in ("matching_scores0", "matching_scores1", "loss"):
            np.testing.assert_allclose(
                np.concatenate([o[key].numpy() for o in outs]), jout[key],
                rtol=1e-9, atol=1e-12, err_msg=key)


@pytest.mark.parametrize("run", ["plain", "default"])
def test_collectives_of_a_seq_step(seq_runs, run):
    """Per step and rank: one gather of the inputs, one of the keys a GNN
    layer and one of the tail each way, and the data-parallel ones (two
    all-reduces a plain BatchNorm call each way, one a whole-layer call,
    each cloud, each way, the gradients, the loss)."""
    got, _ = seq_runs
    layers = 2 * TINY["L"]
    # encoders: 2 BatchNorms in the keypoint encoder, 1 in the descriptor
    # encoder, both clouds
    bn = 2 * 3 + (0 if run == "default" else 2 * layers)
    want = {"input_gather": 1, "kv_gather": layers,
            "kv_gather_backward": layers, "tail_gather": 1,
            "tail_gather_backward": 1, "bn": 2 * bn, "bn_backward": 2 * bn,
            "gradients": 1, "loss": 1}
    if run == "default":
        want.update(layer_bn=2 * layers, layer_bn_backward=2 * layers)
    for layout in ("1x2", "2x2"):
        for rank in got[layout]:
            assert rank[run]["counts"] == [want] * STEPS


def test_gather_and_its_backward_against_the_closed_form(seq_runs):
    """y_i = the members' blocks side by side; d/dx_i^r of sum_m <w_i^m,
    y_i> = sum_m w_i^m restricted to block r. One collective each way, the
    boolean block through the same gather."""
    ranks = seq_runs[0]["1x2"]
    members = [gather_blocks(GATHER["shapes"], GATHER["seed"], r)
               for r in range(2)]
    ys = [torch.cat([m[0][i] for m in members], 1)
          for i in range(len(GATHER["shapes"]))]
    ws, masks = [], []
    for _, g in members:
        ws.append([torch.randn(y.shape, generator=g, dtype=torch.float64)
                   for y in ys])
        masks.append(torch.rand(GATHER["shapes"][0][:2], generator=g,
                                dtype=torch.float64) < 0.5)
    for r, rank in enumerate(ranks):
        res = rank["gather"]
        assert res["counts"] == {"case": 1, "case_backward": 1,
                                 "case_mask": 1}
        assert torch.equal(res["mask"], torch.cat(masks, 1))
        for i, shape in enumerate(GATHER["shapes"]):
            assert torch.equal(res["ys"][i], ys[i])
            n = shape[1]
            want = sum(w[i] for w in ws)[:, r * n:(r + 1) * n]
            torch.testing.assert_close(res["grads"][i], want, rtol=1e-15,
                                       atol=1e-15)


# ---------------------------------------------------------------------------
# the entry points as two ranks
# ---------------------------------------------------------------------------

SEQ2 = ["--seq_parallel", "2"]


@pytest.fixture(scope="module")
def seq_eval_runs(tmp_path_factory):
    """Both eval entry points as two ranks of one data row, and as one
    process, on one tree and one checkpoint that matches."""
    base = tmp_path_factory.mktemp("seq_eval")
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
    procs = {name: _ranks(script, argv + SEQ2)
             for name, (script, _) in scripts.items()}
    single = {name: _in_process(main, argv)
              for name, (_, main) in scripts.items()}
    return {name: (single[name], _wait(procs[name])) for name in scripts}


@pytest.mark.parametrize("name", ["test", "reg"])
def test_seq_eval_clis_print_the_one_process_lines(seq_eval_runs, name):
    """Rank 0 (seq member 0) prints the one-process aggregate lines and
    every pair's line, on the same 8 pairs; rank 1 prints neither."""
    single, (rank0, rank1) = seq_eval_runs[name]
    assert _aggregates(single) and _aggregates(rank0) == _aggregates(single)
    assert _pair_lines(rank0) == _pair_lines(single)
    assert not _aggregates(rank1) and not _pair_lines(rank1)
    assert "[timing] 8 pairs" in single and "[timing] 8 pairs" in rank0
    assert "rank 0/2 (data 0/1, seq 0/2)" in rank0
    assert "rank 1/2 (data 0/1, seq 1/2)" in rank1


def test_seq_train_cli_equals_one_process(tmp_path):
    """``train_torch.py --seq_parallel 2`` as two ranks for two steps: rank
    0 alone writes the checkpoint, and its weights and running statistics
    are those of the same run as one process, to 1e-9; the refusal of a
    keypoint count S does not divide comes before any step."""
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
    procs = _ranks("train_torch.py", argv + SEQ2, cwds)
    one = tmp_path / "one"
    one.mkdir()
    old = os.getcwd()
    os.chdir(one)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            summary = train_torch.main(argv + ["--model_out_path",
                                               str(one / "ck")])
            with pytest.raises(ValueError, match="--max_keypoints"):
                train_torch.main(argv + ["--max_keypoints", "63", *SEQ2])
    finally:
        os.chdir(old)
    outs = _wait(procs)
    assert "Checkpoint saved to" in outs[0]
    assert "Checkpoint saved to" not in outs[1]
    assert os.listdir(cwds[1][0]) == []
    found = [os.path.join(d, n) for d, _, names in os.walk(cwds[0][0])
             for n in names if n.endswith(".pth")]
    assert len(found) == 1
    want = load_pth_state_dict(summary["checkpoints"][-1])
    got = load_pth_state_dict(found[0])
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key].numpy(), w.numpy(), rtol=1e-9,
                                   atol=1e-9, err_msg=key)
