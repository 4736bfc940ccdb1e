"""One-process multi-device serving of the port against the JAX package's.

``Matcher(data_parallel=N, seq_parallel=M)`` of the port (N x M replicas as
threads on the CPU, ``parallel/smap.py::make_eval_runtime`` over
``parallel/local.py::LocalGroup``) against the JAX package's
``Matcher(data_parallel=N, seq_parallel=M, shard_map=True)`` on the virtual
CPU devices, on one ``.npz`` and the pairs of ``tests/test_api.py``'s mesh
test (three pairs: N = 2 and 4 leave a fill row), at float64: equal
matches, scores within 1e-9. Then the grid against the port's one-device
``Matcher``, the gathers it counts, the refusals, a member that raises,
the gather's backward, and the counters under many threads.
"""

import sys
import threading
import time

import numpy as np
import jax
import pytest
import torch

from mdgat_tpu.api import Matcher as JaxMatcher
from mdgat_tpu.core.checkpoint import save_checkpoint
from mdgat_tpu.models import MDGAT as JaxMDGAT
from mdgat_tpu.train import create_train_state

from mdgat_tpu_torch import Matcher
from mdgat_tpu_torch.parallel import (LocalGroup, all_gather,
                                      collective_counts, make_eval_runtime)
from mdgat_tpu_torch.utils.counting import tick, tick_kind

from test_api import TINY
from test_model import tiny_cfg

GRIDS = [(4, 2), (2, 1), (1, 2)]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """The JAX package's tiny checkpoint of ``tests/test_api.py``."""
    model = JaxMDGAT(tiny_cfg())
    state, _ = create_train_state(model, jax.random.PRNGKey(2), 1e-4)
    path = str(tmp_path_factory.mktemp("ck") / "m.npz")
    save_checkpoint(path, jax.device_get(state.params),
                    jax.device_get(state.bn_state), epoch=1, lr=1e-4,
                    loss=0.5)
    return path


def _pairs(seed=31, sizes=(50, 130, 64)):
    """Pairs whose second cloud is 40 points larger: mixed buckets."""
    rng = np.random.default_rng(seed)

    def mk(n):
        return dict(kp0=rng.normal(size=(n, 3)) * 10,
                    desc0=rng.normal(size=(n, 33)),
                    score0=rng.uniform(10, 30, (n,)),
                    kp1=rng.normal(size=(n + 40, 3)) * 10,
                    desc1=rng.normal(size=(n + 40, 33)),
                    score1=rng.uniform(10, 30, (n + 40,)))
    return [mk(n) for n in sizes]


def _same(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key in ("matches0", "matches1"):
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
        for key in ("matching_scores0", "matching_scores1"):
            np.testing.assert_allclose(g[key], w[key], rtol=tol, atol=tol,
                                       err_msg=key)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_grid_equals_the_jax_matchers_mesh(checkpoint, grid):
    n, m = grid
    pairs = _pairs()
    want = JaxMatcher(checkpoint, **TINY, data_parallel=n, seq_parallel=m,
                      shard_map=True)
    assert want._shard_inputs is not None, "JAX mesh runtime not engaged"
    got = Matcher(checkpoint, device="cpu", **TINY, data_parallel=n,
                  seq_parallel=m)
    assert len(got._step.replicas) == n and len(got._step.replicas[0]) == m
    _same(got.match_batch(pairs), want.match_batch(pairs), 1e-9)


def test_grid_equals_one_device_and_counts_its_gathers(checkpoint):
    """4 x 2 against one device on a 3-pair batch (one fill row) and a
    5-pair batch (three): the same results; every member of every row
    gathers once the inputs, once a GNN layer and once the tail; a data
    axis alone gathers nothing; no thread of the grid outlives a call."""
    single = Matcher(checkpoint, device="cpu", **TINY)
    grid = Matcher(checkpoint, device="cpu", **TINY, data_parallel=4,
                   seq_parallel=2)
    rows = Matcher(checkpoint, device="cpu", **TINY, data_parallel=4)
    for pairs in (_pairs(), _pairs(7, (20, 140, 90, 128, 5))):
        want = single.match_batch(pairs)
        collective_counts.clear()
        _same(grid.match_batch(pairs), want, 1e-12)
        layers = 2 * TINY["L"]
        assert dict(collective_counts) == {
            "input_gather": 8, "kv_gather": 8 * layers, "tail_gather": 8}
        collective_counts.clear()
        _same(rows.match_batch(pairs), want, 1e-12)
        assert not collective_counts
    assert not [t for t in threading.enumerate()
                if t.name.startswith("mdgat-eval")]


def test_plain_route_and_shard_map_false_run_one_forward(checkpoint):
    """``resolve_shard_map`` false (no kernel route, or ``shard_map=False``)
    is one forward on the first device, as the JAX package falls back to
    its plain step; the batch still pads to the data axis and trims."""
    want = Matcher(checkpoint, device="cpu", **TINY).match_batch(_pairs())
    for kw in (dict(use_kernels=False), dict(shard_map=False)):
        m = Matcher(checkpoint, device="cpu", **TINY, data_parallel=2,
                    seq_parallel=2, **kw)
        assert m._step.replicas == [[m.model]]
        collective_counts.clear()
        _same(m.match_batch(_pairs()), want, 1e-12)
        assert not collective_counts


@pytest.mark.parametrize("kw, match", [
    (dict(seq_parallel=3), "does not divide"),
    (dict(seq_parallel=2, descriptor="FPFH_gloabal"), "FPFH_gloabal"),
    (dict(data_parallel=2, descriptor="pointnetmsg"), "raw clouds"),
    (dict(data_parallel=2, device="cuda"), "visible"),
    (dict(data_parallel=2, devices=["cpu"] * 3), "needs 2 devices"),
    (dict(data_parallel=0), "at least 1"),
], ids=["seq3", "gloabal", "pointnet", "no_cards", "devices", "no_rows"])
def test_refusals_before_any_forward(kw, match):
    kw = dict(dict(device="cpu"), **kw)
    if kw["device"] == "cuda" and torch.cuda.is_available():
        kw["data_parallel"] = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match=match):
        Matcher(seed=0, L=1, **kw)


def test_a_member_that_raises_fails_the_call(checkpoint):
    """A seq member that raises in the middle of the forward: the call
    re-raises its exception at once (its row's other member leaves the
    barrier it waits at), no grid thread is left, and the next call on
    healthy replicas serves again."""
    m = Matcher(checkpoint, device="cpu", **TINY, data_parallel=2,
                seq_parallel=2)
    proj = m._step.replicas[1][1].final_proj

    def fail(*args):
        raise RuntimeError("planted failure")
    proj.forward = fail
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="planted failure"):
        m.match_batch(_pairs())
    assert time.perf_counter() - t0 < 30
    assert not [t for t in threading.enumerate()
                if t.name.startswith("mdgat-eval")]
    del proj.forward
    want = Matcher(checkpoint, device="cpu", **TINY).match_batch(_pairs())
    _same(m.match_batch(_pairs()), want, 1e-12)


def test_a_member_that_never_arrives_times_out():
    """A member alone at a barrier gives up after the group's timeout."""
    group = LocalGroup(["cpu", "cpu"], timeout=0.2)
    with group.member(0), pytest.raises(threading.BrokenBarrierError):
        group.all_gather(torch.zeros(2))


def test_local_gather_forward_and_no_backward():
    """Two members on two threads: each gets both blocks in member order
    (and the boolean ones back as booleans); a gather under autograd has
    no backward over a ``LocalGroup``."""
    group = LocalGroup(["cpu", "cpu"])
    got, errors = {}, []

    def member(s):
        try:
            with group.member(s):
                x = torch.full((1, 2, 3), float(s), dtype=torch.float64,
                               requires_grad=True)
                mk = all_gather(torch.tensor([[s == 0, True]]), group,
                                "input_gather")
                y = all_gather(x, group, "kv_gather")
                got[s] = (y.detach(), mk)
                y.sum().backward()
        except RuntimeError as e:
            errors.append(e)
    threads = [threading.Thread(target=member, args=(s,)) for s in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    for s in (0, 1):
        y, mk = got[s]
        assert y.shape == (1, 4, 3)
        assert torch.equal(y[0, :2], torch.zeros(2, 3, dtype=torch.float64))
        assert torch.equal(y[0, 2:], torch.ones(2, 3, dtype=torch.float64))
        assert mk.dtype == torch.bool
        assert mk.tolist() == [[True, True, False, True]]
    assert len(errors) == 2 and all("no backward" in str(e) for e in errors)


def test_sinkhorn_plan_as_holds_in_its_thread_only():
    """``plan_as`` names the pair count the Sinkhorn forward plans for, in
    the calling thread, until its block ends."""
    from mdgat_tpu_torch.ops.cuda import sinkhorn
    seen = []
    with sinkhorn.plan_as(64):
        t = threading.Thread(
            target=lambda: seen.append(sinkhorn._PLAN_PAIRS.get()))
        t.start()
        t.join(30)
        assert sinkhorn._PLAN_PAIRS.get() == 64
    assert seen == [None] and sinkhorn._PLAN_PAIRS.get() is None
    # the plans the grid keeps apart: 64 pairs and 32 take other clusters
    assert sinkhorn.sinkhorn_plan(64, 256, 256) != sinkhorn.sinkhorn_plan(
        32, 256, 256)


def test_make_eval_runtime_needs_a_device_a_cell():
    from mdgat_tpu_torch.core.config import test_defaults
    from mdgat_tpu_torch.models.mdgat import MDGAT
    cfg = test_defaults(L=1, data_parallel=2, seq_parallel=2)
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_eval_runtime(MDGAT(cfg), cfg, ["cpu"] * 3)


def test_counters_do_not_lose_ticks_under_threads():
    """16 threads tick one attribute and one Counter entry 2000 times each
    with the interpreter switching threads every microsecond: no tick is
    lost."""
    class Wrapper:
        launches = 0
    counts = collective_counts.__class__()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                tick(Wrapper)
                tick_kind(counts, "kv_gather")
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert Wrapper.launches == counts["kv_gather"] == 16 * 2000
