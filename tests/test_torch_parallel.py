"""The port's data-parallel layer (``mdgat_tpu_torch/parallel``) against the
JAX package's ``parallel/`` on the CPU.

* The row and pair arithmetic: ``process_batch_rows``, ``eval_pair_range``
  and ``SparseDataset.batches(rows=, pair_range=)`` against the JAX
  functions on one synthetic tree (the same rows, the same bucket N, the
  same errors).
* The training step as two ranks: two gloo worker processes
  (``torch_parallel_worker.py``, no JAX) run ``make_train_step(group)`` on
  their halves of the same global batches at float64, (b) on the plain
  path against the JAX package's ``make_shard_map_train_step`` on a
  2-device mesh of the virtual CPU devices, from the same weights (loss,
  grad_norm, every updated parameter and BatchNorm running statistic to
  1e-9); (c) on the default route (``train_layer=True``, on the CPU the
  whole-layer kernels' twin, single-pass variance) and (d) with the
  ``pointnet`` encoder (the cross-rank BatchNorm of ``apply_conv_bn_stack``)
  against the port's own one-process step on the global batches, to 1e-9.
  The two ranks end bit-equal, and each step issues the collectives it
  should, by kind.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from mdgat_tpu.core.config import train_defaults as jax_train_defaults
from mdgat_tpu.data import SparseDataset as JaxSparseDataset
from mdgat_tpu.models import MDGAT as JaxMDGAT
from mdgat_tpu.parallel import make_mesh
from mdgat_tpu.parallel import multihost as jax_multihost
from mdgat_tpu.parallel import replicate as jax_replicate
from mdgat_tpu.parallel import shard_batch as jax_shard_batch
from mdgat_tpu.parallel.smap import make_shard_map_train_step
from mdgat_tpu.train.loop import TrainState as JaxTrainState

from mdgat_tpu_torch.core.checkpoint import state_dict_from_numpy
from mdgat_tpu_torch.core.config import train_defaults
from mdgat_tpu_torch.data.pipeline import (SparseDataset, collate_pairs,
                                           model_inputs, prepare_batch)
from mdgat_tpu_torch.data.synthetic import (make_synthetic_pair,
                                            write_synthetic_kitti)
from mdgat_tpu_torch.models.mdgat import MDGAT
from mdgat_tpu_torch.parallel import multihost, shard_batch
from mdgat_tpu_torch.train import create_train_state, make_train_step

from test_torch_train_step import TINY, _batch, _weights

HERE = os.path.dirname(os.path.abspath(__file__))
LR = 1e-3
STEPS = 2
F64 = dict(param_dtype="float64", compute_dtype="float64")


# ---------------------------------------------------------------------------
# (a) rows and pairs
# ---------------------------------------------------------------------------

@pytest.fixture
def ranks(monkeypatch):
    """``set(rank, world)``: both packages' multi-process helpers see this
    process as that rank of that many."""
    def set_(rank, world):
        monkeypatch.setattr(multihost, "process_index", lambda: rank)
        monkeypatch.setattr(multihost, "process_count", lambda: world)
        monkeypatch.setattr(jax_multihost.jax, "process_index", lambda: rank)
        monkeypatch.setattr(jax_multihost.jax, "process_count", lambda: world)
    return set_


@pytest.mark.parametrize("n_total, max_pairs, batch", [
    (10, 6, 4), (10, 8, 4), (10, 0, 4), (7, 6, 4), (256, 0, 64),
    (200, 130, 64), (5, 0, 1)])
@pytest.mark.parametrize("world", [1, 2, 3])
def test_eval_pair_range_equals_jax(ranks, n_total, max_pairs, batch, world):
    """Every rank's block equals the JAX package's; the blocks tile the
    capped prefix, which is rounded up to whole batches (one process
    evaluates ``ceil(max_pairs / batch) * batch`` pairs)."""
    blocks = []
    for rank in range(world):
        ranks(rank, world)
        got = multihost.eval_pair_range(n_total, max_pairs, batch)
        assert got == jax_multihost.eval_pair_range(n_total, max_pairs, batch)
        blocks.append(got)
    total = (min(n_total, -(-max_pairs // batch) * batch) if max_pairs
             else n_total)
    assert blocks[0][0] == 0 and blocks[-1][1] == total
    assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))


def test_process_batch_rows(ranks):
    """One process owns every row, as the JAX package's single-process mesh
    gives; W ranks own equal contiguous blocks in rank order (the rows the
    JAX package's multi-process workers assert); a batch W does not divide
    raises."""
    mesh = make_mesh(data=8, seq=1)
    assert (multihost.process_batch_rows(16)
            == jax_multihost.process_batch_rows(mesh, 16) == slice(0, 16))
    for world in (2, 4):
        got = []
        for rank in range(world):
            ranks(rank, world)
            got.append(multihost.process_batch_rows(8))
        assert got == [slice(r * 8 // world, (r + 1) * 8 // world)
                       for r in range(world)]
    ranks(1, 3)
    with pytest.raises(ValueError, match="not a multiple of the 3 ranks"):
        multihost.process_batch_rows(8)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("parallel_tree"))
    kp_dir = write_synthetic_kitti(root, seqs=(0, 2, 3, 4, 5, 6, 7, 10),
                                   frames_per_seq=5, pairs_per_seq=6,
                                   n_points=150, seed=3)
    return dict(train_path=root, keypoints_path=kp_dir,
                txt_path=os.path.join(root, "preprocess-random-full"),
                max_keypoints=96, memory_is_enough=False)


def _same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if k == "sequence":
                assert g[k] == w[k]
            else:
                np.testing.assert_array_equal(g[k], np.asarray(w[k]), k)
    return got


@pytest.mark.parametrize("ensure", [True, False], ids=["fixed", "bucketed"])
def test_batches_rows_equal_jax(tree, ensure):
    """``rows=``: the rank's rows of each shuffled global batch, padded to
    the global batch's bucket, equal to the JAX package's and to the rows
    of the full batches."""
    pcfg = train_defaults(**tree, ensure_kpts_num=ensure)
    jcfg = jax_train_defaults(**tree, ensure_kpts_num=ensure)
    port, jds = SparseDataset(pcfg, "train"), JaxSparseDataset(jcfg, "train")
    full = list(port.batches(4, shuffle=True, seed=7))
    for rows in (slice(0, 2), slice(2, 4)):
        part = _same_batches(
            port.batches(4, shuffle=True, seed=7, rows=rows),
            jds.batches(4, shuffle=True, seed=7, rows=rows, use_native=False))
        _same_batches(part, [shard_batch(f, rows) for f in full])
    if not ensure:
        # the bucket is the global batch's, so both halves pad alike
        sizes = {b["keypoints0"].shape[1] for b in full}
        assert sizes and all(s % 128 == 0 for s in sizes)


@pytest.mark.parametrize("ensure", [True, False], ids=["fixed", "bucketed"])
def test_batches_pair_range_equal_jax(tree, ensure):
    """``pair_range=``: batches formed from that block of the pair list
    alone, a short last batch kept, as the JAX package forms them."""
    pcfg = train_defaults(**tree, ensure_kpts_num=ensure)
    jcfg = jax_train_defaults(**tree, ensure_kpts_num=ensure)
    port, jds = SparseDataset(pcfg, "test"), JaxSparseDataset(jcfg, "test")
    got = _same_batches(
        port.batches(2, drop_last=False, pair_range=(1, 6)),
        jds.batches(2, drop_last=False, pair_range=(1, 6), use_native=False))
    assert [len(b["idx0"]) for b in got] == [2, 2, 1]


def test_batches_refuse_what_jax_refuses(tree):
    ds = SparseDataset(train_defaults(**tree), "train")
    jds = JaxSparseDataset(jax_train_defaults(**tree), "train")
    for d in (ds, jds):
        with pytest.raises(ValueError, match="drop_last"):
            next(d.batches(4, drop_last=False, rows=slice(0, 2)))
        with pytest.raises(ValueError, match="mutually exclusive"):
            next(d.batches(4, rows=slice(0, 2), pair_range=(0, 8)))


# ---------------------------------------------------------------------------
# (b) - (d) the training step as two ranks
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(spec, base, world=2, seq=1):
    """The worker as ``world`` gloo ranks over ``spec`` (``world / seq``
    data rows of ``seq`` members); their results."""
    spec_path, out = str(base / "spec.pt"), str(base / "out.pt")
    torch.save(spec, spec_path)
    port = _free_port()
    # tiny tensors: one thread a rank (several ranks, each with a thread a
    # core spinning at every collective, would crowd each other out)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_parallel_worker.py"),
         str(r), str(world), str(port), spec_path, out, str(seq)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [torch.load(f"{out}.{r}", weights_only=False)
            for r in range(world)]


def _one_process(config, state_dict, batches):
    state = create_train_state(train_defaults(**config), device="cpu",
                               learning_rate=LR, state_dict=state_dict)
    step = make_train_step()
    metrics = []
    for batch in batches:
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(metrics=metrics, state=state.model.state_dict())


def _pointnet_case():
    """Seeded port weights and a global batch of 4 pairs of 24 keypoints
    with raw clouds of 200 points around them, for the ``pointnet``
    encoder."""
    config = dict(TINY, L=1, descriptor="pointnet", **F64)
    model = MDGAT(train_defaults(**config))
    model.reset_parameters(4)
    rng = np.random.default_rng(1400)
    pairs = [make_synthetic_pair(rng, n_points=24, overlap=0.8) for _ in range(4)]
    batch = model_inputs(prepare_batch(
        collate_pairs(pairs, max_keypoints=24, dtype=np.float64), 0.5, False,
        "cpu", torch.float64, torch.float64))
    for side in "01":
        kp = batch["keypoints" + side].numpy()
        pick = rng.integers(0, 24, size=(4, 200))
        xyz = (np.take_along_axis(kp, pick[..., None], axis=1)
               + rng.normal(scale=0.8, size=(4, 200, 3)))
        batch["cloud" + side] = torch.from_numpy(
            np.concatenate([xyz, rng.normal(size=(4, 200, 5))], -1))
    return config, model.state_dict(), [batch] * STEPS


def _jax_shard_map(params, bn_state, batch, pcfg):
    """The JAX package's shard_map step on a 2-device data axis, STEPS
    times: per-step metrics and the final state, named like the port's."""
    jcfg = jax_train_defaults(**TINY, loss_method="gap_loss", **F64)
    model = JaxMDGAT(jcfg)
    tx = optax.adam(LR)
    jp = jax.tree.map(jnp.asarray, params)
    state = JaxTrainState(jp, jax.tree.map(jnp.asarray, bn_state),
                          tx.init(jp), jnp.zeros((), jnp.int32))
    mesh = make_mesh(data=2, seq=1, devices=jax.devices()[:2])
    step = make_shard_map_train_step(model, tx, mesh, donate=False)
    state = jax_replicate(state, mesh)
    jbatch = jax_shard_batch({k: v.numpy() for k, v in batch.items()}, mesh)
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, jbatch)
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(metrics=metrics, state=state_dict_from_numpy(
        jax.tree.map(np.asarray, state.params),
        jax.tree.map(np.asarray, state.bn_state), pcfg))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The three runs on two ranks, and what each is held against."""
    params, bn_state = _weights("float64")
    batch = _batch("float64")
    fpfh = dict(TINY, loss_method="gap_loss", **F64)
    plain = dict(fpfh, use_kernels=False)
    weights = state_dict_from_numpy(params, bn_state, train_defaults(**fpfh))
    pn_config, pn_weights, pn_batches = _pointnet_case()
    spec = {
        "plain": dict(config=plain, state_dict=weights, lr=LR,
                      batches=[batch] * STEPS),
        "default": dict(config=fpfh, state_dict=weights, lr=LR,
                        batches=[batch] * STEPS),
        "pointnet": dict(config=pn_config, state_dict=pn_weights, lr=LR,
                         batches=pn_batches),
    }
    ranks = _run_ranks(spec, tmp_path_factory.mktemp("two_ranks"))
    want = {
        "plain": _jax_shard_map(params, bn_state, batch,
                                train_defaults(**plain)),
        "default": _one_process(fpfh, weights, [batch] * STEPS),
        "pointnet": _one_process(pn_config, pn_weights, pn_batches),
    }
    return ranks, want


@pytest.mark.parametrize("run", ["plain", "default", "pointnet"])
def test_two_ranks_give_the_global_batch_step(two_ranks, run):
    """plain: against the JAX package's 2-device shard_map step; default
    and pointnet: against the port's one-process step on the global batch.
    Loss and grad_norm of each step to 1e-9 relative, every parameter and
    BatchNorm running statistic after the last step to 1e-9."""
    ranks, want = two_ranks
    got, want = ranks[0][run], want[run]
    for g, w in zip(got["metrics"], want["metrics"]):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-9, atol=0,
                                       err_msg=key)
    assert got["metrics"][-1]["loss"] < got["metrics"][0]["loss"]
    assert sorted(got["state"]) == sorted(want["state"])
    for key, w in want["state"].items():
        if key.endswith("num_batches_tracked"):
            # the JAX package keeps no such counter
            assert run == "plain" or torch.equal(got["state"][key], w), key
            continue
        np.testing.assert_allclose(got["state"][key].numpy(), w.numpy(),
                                   rtol=1e-9, atol=1e-9, err_msg=key)


@pytest.mark.parametrize("run", ["plain", "default", "pointnet"])
def test_two_ranks_end_bit_equal(two_ranks, run):
    """The same metrics and the same bits in every parameter, running
    statistic and counter on both ranks."""
    r0, r1 = (r[run] for r in two_ranks[0])
    assert r0["metrics"] == r1["metrics"]
    assert sorted(r0["state"]) == sorted(r1["state"])
    for key, t in r0["state"].items():
        assert torch.equal(t, r1["state"][key]), key


def _bn_calls(config):
    """(plain BatchNorm calls, whole-layer train-kernel calls) of one
    training forward of ``config`` (both clouds)."""
    cfg = train_defaults(**config)
    model = MDGAT(cfg)
    per_cloud = 0
    for name in ("kenc", "denc", "penc"):
        if hasattr(model, name):
            per_cloud += sum(type(m).__name__ == "BatchNorm"
                             for m in getattr(model, name).modules())
    layers = 2 * cfg.L * 2
    if cfg.use_kernels and cfg.train_layer:
        return 2 * per_cloud, layers
    return 2 * per_cloud + layers, 0


@pytest.mark.parametrize("run", ["plain", "default", "pointnet"])
def test_collectives_of_a_step(two_ranks, run):
    """Each step issues, on each rank: two all-reduces for each plain
    BatchNorm call forward and two backward; one for each whole-layer call
    forward and one backward; one of the gradients; one of the loss."""
    config = {"plain": dict(TINY, use_kernels=False), "default": TINY,
              "pointnet": dict(TINY, L=1, descriptor="pointnet")}[run]
    bn, layers = _bn_calls(config)
    want = {"bn": 2 * bn, "bn_backward": 2 * bn, "gradients": 1, "loss": 1}
    if layers:
        want.update(layer_bn=layers, layer_bn_backward=layers)
    for rank in two_ranks[0]:
        assert rank[run]["counts"] == [want] * STEPS
