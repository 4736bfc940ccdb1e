"""The port's counterpart of ``jax.jit``: ``utils/graphs.py::Captured`` and
the captured train step, eval step and ``Matcher``.

A CUDA graph cannot be captured on the CPU, so the tests put a stand-in in
the place of the backend (``graphs.BACKEND``): it captures nothing and
re-runs the step on the graph's static input buffers at every replay,
writing into static output buffers that it hands back, as a replayed graph
overwrites its outputs. With it the cache's keys, its warm-up / capture /
replay order, the clones of the outputs, the least-recently-used bound and
the eager cases are checked, and the steps through the cache are held to
the eager steps bit for bit, and the gradient buffers stay in place from
step to step (``tests/test_torch_train_step.py``'s float64 tests hold that
step against the JAX package's ``make_train_step`` for three steps). The
optimizer is one constructor's in ``create_train_state`` and
``load_train_checkpoint``, and
a training ``.pth`` written with a capturable Adam's options loads in the
JAX package, and the JAX package's in the port.
"""

import numpy as np
import pytest
import torch

from mdgat_tpu.core.checkpoint import load_pth_checkpoint, save_pth_checkpoint
from mdgat_tpu.core.config import train_defaults as jax_train_defaults

from mdgat_tpu_torch import Matcher
from mdgat_tpu_torch.core.checkpoint import (load_train_checkpoint,
                                             save_train_checkpoint,
                                             state_dict_from_numpy)
from mdgat_tpu_torch.core.config import train_defaults
from mdgat_tpu_torch.ops.cuda.sinkhorn import plan_as
from mdgat_tpu_torch.train import (create_train_state, make_eval_step,
                                   make_train_step)
from mdgat_tpu_torch.train.loop import make_optimizer
from mdgat_tpu_torch.utils import graphs
from mdgat_tpu_torch.utils.graphs import Captured, use_graphs

from test_torch_matcher_mesh import _pairs
from test_torch_train_step import LR, TINY, _batch

MESH_TINY = dict(L=2, k=(8, None, 4, None), descriptor_dim=32,
                 keypoint_encoder=(16, 32), descriptor_encoder=(16,),
                 sinkhorn_iterations=8, compute_dtype="float64",
                 param_dtype="float64")


class StandIn:
    """The CPU stand-in of ``graphs.CudaGraphs``: no capture; a replay
    re-runs the step on the static inputs and copies its outputs into
    static outputs, which it returns."""

    def __init__(self, fail_capture=False):
        self.fail_capture = fail_capture

    @staticmethod
    def supports(device):
        return device.type == "cpu"

    @staticmethod
    def context(device):
        return {}

    @staticmethod
    def warm_up(fn, batch, ctx):
        return fn(batch)

    def capture(self, fn, static, ctx):
        if self.fail_capture:
            raise RuntimeError("capture failed")
        box = {}

        def replay():
            out = fn(static)
            if "out" not in box:
                box["out"] = graphs._map(torch.clone, out)
            else:
                _copy_into(box["out"], out)
            return box["out"]
        return replay

    @staticmethod
    def before_replay(ctx, device):
        pass

    @staticmethod
    def after_replay(ctx, device):
        pass

    @staticmethod
    def release(ctx):
        pass


def _copy_into(dst, src):
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            _copy_into(d, s)
    else:
        dst.copy_(src)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for these tiny shapes: faster alone, and it
    leaves the cores to the other test workers. Both sides of every
    comparison here run under it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def stand_in(monkeypatch):
    backend = StandIn()
    monkeypatch.setattr(graphs, "BACKEND", backend)
    return backend


def _counts(cap):
    return cap.warm_ups, cap.captures, cap.replays


def test_first_call_warms_up_the_second_captures_then_replays(stand_in):
    calls = []

    def fn(b):
        calls.append(1)
        return {"y": b["x"] * 2}

    cap = Captured(fn)
    x = torch.arange(3.0)
    np.testing.assert_array_equal(cap({"x": x})["y"].numpy(), [0, 2, 4])
    assert _counts(cap) == (1, 0, 0) and len(calls) == 1
    np.testing.assert_array_equal(cap({"x": x + 1})["y"].numpy(), [2, 4, 6])
    assert _counts(cap) == (1, 1, 1)
    cap({"x": x})
    assert _counts(cap) == (1, 1, 2) and len(cap) == 1


@pytest.mark.parametrize("change", ["shape", "dtype", "key", "name"])
def test_another_shape_dtype_key_or_input_is_another_entry(stand_in, change):
    cap = Captured(lambda b: {k: v + 1 for k, v in b.items()})
    f32 = torch.float32
    base = {"x": torch.zeros(4, dtype=f32)}
    cap(base, key=("eval", 64))
    cap(base, key=("eval", 64))            # a hit: captured
    other, key = dict(base), ("eval", 64)
    if change == "shape":
        other = {"x": torch.zeros(5, dtype=f32)}
    elif change == "dtype":
        other = {"x": torch.zeros(4, dtype=torch.float64)}
    elif change == "key":
        key = ("eval", 32)                 # another Sinkhorn plan
    else:
        other = {"y": torch.zeros(4, dtype=f32)}
    assert cap.signature(other, key) != cap.signature(base, ("eval", 64))
    cap(other, key=key)
    assert _counts(cap) == (2, 1, 1) and len(cap) == 2
    cap(base, key=("eval", 64))
    assert _counts(cap) == (2, 1, 2)


def test_outputs_are_clones_that_no_replay_overwrites(stand_in):
    """``train_torch.py`` keeps each step's loss tensor until the epoch
    ends: every kept value must stay its own step's."""
    cap = Captured(lambda b: {"loss": b["x"].sum()})
    kept = [cap({"x": torch.full((3,), float(i))})["loss"] for i in range(5)]
    assert [float(t) for t in kept] == [0.0, 3.0, 6.0, 9.0, 12.0]
    assert len({t.data_ptr() for t in kept}) == 5


def test_threads_share_one_cache_without_a_lost_update(stand_in):
    """Callers of one cache on many threads take turns: every output is
    its own call's, and the counts add up (two keys: two warm-ups, two
    captures, a replay for every other call)."""
    import sys
    import threading
    cap = Captured(lambda b: {"y": b["x"] * 2})
    errors, calls = [], 20
    interval = sys.getswitchinterval()

    def worker(i):
        try:
            for j in range(calls):
                x = torch.full((1 + (i + j) % 2,), float(i * calls + j))
                if not torch.equal(cap({"x": x})["y"], x * 2):
                    errors.append((i, j))
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    assert _counts(cap) == (2, 2, 16 * calls - 2)


def test_least_recently_used_graph_goes_first(stand_in):
    cap = Captured(lambda b: {"y": b["x"] * 1}, max_graphs=2)
    a, b, c = ({"x": torch.zeros(n)} for n in (1, 2, 3))
    for batch in (a, a, b, b):
        cap(batch)
    cap(a)                                  # a is now the most recent
    cap(c)                                  # b goes
    assert len(cap) == 2
    assert cap.signature(b) not in cap._entries
    assert cap.signature(a) in cap._entries
    warm = cap.warm_ups
    cap(b)                                  # b starts over: a warm-up
    assert cap.warm_ups == warm + 1 and cap.signature(a) not in cap._entries


def test_a_failed_capture_raises_and_runs_nothing_eagerly(monkeypatch):
    monkeypatch.setattr(graphs, "BACKEND", StandIn(fail_capture=True))
    calls = []

    def fn(b):
        calls.append(1)
        return {"y": b["x"]}

    cap = Captured(fn)
    cap({"x": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="capture failed"):
        cap({"x": torch.zeros(2)})
    assert len(calls) == 1 and len(cap) == 0 and cap.captures == 0


@pytest.mark.parametrize("case", ["cpu", "plain_route", "cuda_graphs_off",
                                  "disabled", "debug_nans", "wide_clouds"])
def test_each_eager_case_takes_the_eager_path(case):
    cfg = train_defaults()
    device = "cuda"
    batch = {"keypoints0": torch.zeros(2, 1024, 3),
             "keypoints1": torch.zeros(2, 1024, 3)}
    assert use_graphs(cfg, device, batch)
    if case == "cpu":
        device = "cpu"
    elif case == "plain_route":
        cfg = cfg.replace(use_kernels=False)
    elif case == "cuda_graphs_off":
        cfg = cfg.replace(cuda_graphs=False)
    elif case == "wide_clouds":
        batch["keypoints1"] = torch.zeros(2, 1025, 3)
    if case == "disabled":
        with graphs.disabled():
            assert not use_graphs(cfg, device, batch)
        assert use_graphs(cfg, device, batch)
    elif case == "debug_nans":
        with torch.autograd.set_detect_anomaly(True):
            assert not use_graphs(cfg, device, batch)
    else:
        assert not use_graphs(cfg, device, batch)


def test_debug_nans_turns_the_graphs_off():
    from mdgat_tpu_torch.cli import build_parser, config_from_args
    for flag, want in (("false", True), ("true", False)):
        args = build_parser("train").parse_args(["--debug_nans", flag])
        assert config_from_args(args, "train").cuda_graphs is want


def _tiny_state(**over):
    """A train state on the CPU: ``TINY`` cut to one layer pair (the
    checks here are of the cache, not of the model)."""
    cfg = train_defaults(**{**TINY, "L": 1, **over}, param_dtype="float64",
                         compute_dtype="float64")
    return create_train_state(cfg, device="cpu", seed=3, learning_rate=LR)


def test_captured_train_steps_equal_eager_steps(stand_in):
    """Three steps through the cache (warm-up, capture and replay, replay)
    against three eager ones from the same weights: loss, grad_norm, every
    parameter, gradient, running statistic and Adam moment equal."""
    batch = _batch("float64")
    eager = _tiny_state(cuda_graphs=False)
    captured = _tiny_state()
    step = make_train_step()
    ptrs = []
    for _ in range(3):
        _, m_e = step(eager, batch)
        _, m_c = step(captured, batch)
        for k in ("loss", "grad_norm"):
            assert torch.equal(m_e[k], m_c[k]), k
        ptrs.append([p.grad.data_ptr() for p in eager.model.parameters()])
    # the gradient buffers are zeroed in place: the same from step to step
    assert ptrs[0] == ptrs[1] == ptrs[2]
    assert eager.graphs is None
    assert _counts(captured.graphs) == (1, 1, 2)
    assert eager.step == captured.step == 3
    for (name, pe), pc in zip(eager.model.named_parameters(),
                              captured.model.parameters()):
        assert torch.equal(pe, pc) and torch.equal(pe.grad, pc.grad), name
        se, sc = eager.optimizer.state[pe], captured.optimizer.state[pc]
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(se[k], sc[k]), (name, k)
    for (name, be), bc in zip(eager.model.named_buffers(),
                              captured.model.buffers()):
        assert torch.equal(be, bc), name


@pytest.mark.parametrize("case", ["plain_route", "cuda_graphs_off",
                                  "disabled"])
def test_eager_train_configs_capture_nothing(stand_in, case):
    state = _tiny_state(**({"use_kernels": False} if case == "plain_route"
                           else {"cuda_graphs": case != "cuda_graphs_off"}))
    batch = _batch("float64")
    step = make_train_step()
    if case == "disabled":
        with graphs.disabled():
            step(state, batch)
    else:
        step(state, batch)
    assert state.graphs is None and state.step == 1


def test_a_data_parallel_step_stays_eager(stand_in):
    """A step over a process group (here gloo, one rank) is
    ``parallel/smap.py``'s and captures nothing: gloo's collectives cannot
    be captured."""
    import socket
    import torch.distributed as dist
    from mdgat_tpu_torch.parallel.mesh import DataParallelGroup
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        group = DataParallelGroup(1, 0, torch.device("cpu"),
                                  dist.group.WORLD, None, 1, 1, 0, 0, None)
        state = _tiny_state()
        batch = _batch("float64")
        make_train_step(group)(state, batch)
        assert state.graphs is None and state.step == 1
    finally:
        dist.destroy_process_group()


def test_replayed_train_step_drops_the_cached_kernel_weights(stand_in):
    state = _tiny_state(kernel_twins=True)
    batch = _batch("float64")
    make_eval_step(state.model)(batch)
    layers = state.model.gnn.layers
    assert all(layer._kernel_key is not None for layer in layers)
    step = make_train_step()
    step(state, batch)
    step(state, batch)
    assert all(layer._kernel_key is None for layer in layers)


def test_captured_eval_step_equals_eager_and_keys_on_the_plan(stand_in):
    state = _tiny_state()
    batch = _batch("float64")
    step = make_eval_step(state.model)
    eager = make_eval_step(_tiny_state(cuda_graphs=False).model)
    want = eager(batch)
    for rows in (None, None, None, 4, 4):
        if rows is None:
            got = step(batch)
        else:
            with plan_as(rows):
                got = step(batch)
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert _counts(step.graphs) == (2, 2, 3) and len(step.graphs) == 2
    assert state.model.training          # the mode is put back


@pytest.mark.parametrize("grid", [(1, 1), (2, 1), (1, 2)],
                         ids=lambda g: f"{g[0]}x{g[1]}")
def test_matcher_through_the_cache_equals_eager(stand_in, grid):
    """One device and a data-only grid capture a graph a cell and bucket;
    a seq row (1 x 2) stays eager. The outputs equal ``cuda_graphs=False``
    on three requests of two buckets."""
    n, m = grid
    kw = dict(seed=4, device="cpu", data_parallel=n, seq_parallel=m,
              **MESH_TINY)
    got_m = Matcher(**kw)
    want_m = Matcher(cuda_graphs=False, **kw)
    for req in (_pairs(), _pairs(seed=7, sizes=(40, 60)), _pairs()):
        got, want = got_m.match_batch(req), want_m.match_batch(req)
        for g, w in zip(got, want):
            for key in g:
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    caches = got_m._step.graphs
    if m > 1:
        assert all(len(c) == 0 for c in caches)
    else:
        assert len(caches) == n
        for c in caches:
            assert _counts(c) == (2, 1, 1)
    assert all(len(c) == 0 for c in want_m._step.graphs)


def test_make_optimizer_is_the_one_optimizer(tmp_path):
    """``create_train_state`` and both resumes of ``load_train_checkpoint``
    build ``make_optimizer``'s Adam; on the card it is capturable with the
    multi-tensor kernels."""
    state = _tiny_state()
    want = make_optimizer(state.model, LR, "cpu").defaults
    assert state.optimizer.defaults == want
    assert not want["capturable"]
    card = make_optimizer(state.model, LR, "cuda").defaults
    assert card["capturable"] and card["foreach"]
    assert {k: v for k, v in card.items()
            if k not in ("capturable", "foreach")} == {
        k: v for k, v in want.items() if k not in ("capturable", "foreach")}
    make_train_step()(state, _batch("float64"))
    path = str(tmp_path / "s.pth")
    save_train_checkpoint(path, state, epoch=1, loss=0.5)
    for fresh in (True, False):
        resumed = _tiny_state()
        load_train_checkpoint(path, resumed, fresh_optimizer=fresh)
        assert resumed.optimizer.defaults == want, fresh


def _jax_cfg():
    return jax_train_defaults(**{**TINY, "L": 1}, param_dtype="float64",
                              compute_dtype="float64")


def test_capturable_adam_checkpoint_loads_in_both_packages(tmp_path):
    """A ``.pth`` as the card writes it (a capturable Adam's groups, every
    tensor on the host) loads in the JAX package's ``load_pth_checkpoint``
    with the port's weights, and resumes on the CPU under the CPU's
    options, its step counts on the host; the next step runs."""
    state = _tiny_state()
    batch = _batch("float64")
    step = make_train_step()
    step(state, batch)
    for group in state.optimizer.param_groups:
        group.update(capturable=True, foreach=True)
    path = str(tmp_path / "card.pth")
    save_train_checkpoint(path, state, epoch=3, loss=0.25)
    saved = torch.load(path, map_location="cpu", weights_only=True)
    assert saved["optimizer"]["param_groups"][0]["capturable"]
    params, bn_state, meta = load_pth_checkpoint(path, _jax_cfg())
    assert meta["epoch"] == 3 and meta["loss"] == 0.25
    want = state.model.state_dict()
    for key, val in state_dict_from_numpy(params, bn_state,
                                          state.model.config).items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(val.numpy(), want[key].numpy(),
                                          err_msg=key)
    resumed = _tiny_state()
    load_train_checkpoint(path, resumed)
    assert resumed.step == 1
    for group in resumed.optimizer.param_groups:
        assert not group["capturable"]
    for st in resumed.optimizer.state.values():
        assert st["step"].device.type == "cpu"
        assert st["step"].dtype == torch.float32
    _, m = step(resumed, batch)
    assert torch.isfinite(m["loss"])


def test_jax_checkpoint_resumes_under_make_optimizer(tmp_path):
    """The JAX package's ``save_pth_checkpoint`` (an Adam state without
    moments) resumes in the port on a fresh ``make_optimizer`` Adam at the
    file's learning rate."""
    state = _tiny_state()
    port = str(tmp_path / "port.pth")
    save_train_checkpoint(port, state)
    params, bn_state, _ = load_pth_checkpoint(port, _jax_cfg())
    path = str(tmp_path / "jax.pth")
    save_pth_checkpoint(path, params, bn_state, _jax_cfg(), epoch=2,
                        lr=5e-4, loss=0.3, dtype=np.float64)
    resumed = _tiny_state()
    meta = load_train_checkpoint(path, resumed)
    assert meta["lr_schedule"] == 5e-4 and resumed.step == 0
    assert resumed.optimizer.defaults == make_optimizer(
        resumed.model, 5e-4, "cpu").defaults
    for key, val in state.model.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(resumed.model.state_dict()[key], val), key

