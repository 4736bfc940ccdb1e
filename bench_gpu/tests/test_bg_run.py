"""A run end to end on the CPU, small, past the look for the card: the
control and the faults each come out as not correct under the cells'
limits, and a run with no card prints no result.

Each cell runs at a size the CPU holds (2 training pairs of 160
keypoints, 8 serving pairs of 200-256, 512-point clouds) on the kernel
routes' twins, with its own limits. The faults are
planted in the program underneath the harness, where the timed path
produces them:

* a training step that leaves the state unchanged (no optimizer update);
* steps after the first (on the card: the capture and the replays) that
  update Adam's moments and leave the parameters where they were;
* half of the batch left out of the training loss, the mean taken over
  the rest;
* an answer altered where it is produced (one match index in the
  forward's output).

The exchange between chips cannot be left out: every cell runs on one.
"""

import copy
import os
import subprocess
import sys
import time

import pytest
import torch

from bench_gpu.harness import cells, checks, common

ROOT = str(common.ROOT)


def small(cell):
    wl = copy.deepcopy(common.workload(cell))
    tr = wl["traffic"]
    tr.update(batch=2, pool=3)
    if wl["kind"] == "train":
        tr.update(sizes=[160, 160], max_keypoints=160)
    else:
        # the serving cells' numbers are widest gaps over the answers: the
        # control shows surely only over some thousands of them
        tr.update(batch=8, sizes=[200, 256], sample_calls=2)
    if tr.get("cloud_points"):
        tr["cloud_points"] = 512
    wl["trace_iters"] = 3
    wl["reference_block"] = 2
    return wl


def run_small(cell, seed=11):
    wl = small(cell)
    run = cells.Run(cell, wl, common.config(wl["config"]), seed, 0.3, False,
                    torch.device("cpu"), time.perf_counter(),
                    overrides={"kernel_twins": True})
    return run, cells.run_cell(run)


def unchanged_state(monkeypatch):
    import mdgat_tpu_torch.train.loop as loop

    def step(state, batch):
        model, opt = state.model, state.optimizer
        opt.zero_grad(set_to_none=False)
        loss = model(batch)["loss"].mean()
        loss.backward()
        return {"loss": loss.detach(), "grad_norm": loss.detach()}
    monkeypatch.setattr(loop, "_train_step", step)


def frozen_parameters(monkeypatch):
    import mdgat_tpu_torch.train.loop as loop
    sound, calls = loop._train_step, []

    def step(state, batch):
        calls.append(1)
        if len(calls) == 1:
            return sound(state, batch)
        params = list(state.model.parameters())
        before = [p.detach().clone() for p in params]
        out = sound(state, batch)
        with torch.no_grad():
            for p, b in zip(params, before):
                p.copy_(b)
        return out
    monkeypatch.setattr(loop, "_train_step", step)


def half_batch(monkeypatch):
    import mdgat_tpu_torch.train.loop as loop

    def step(state, batch):
        model, opt = state.model, state.optimizer
        opt.zero_grad(set_to_none=False)
        per = model(batch)["loss"]
        loss = per[:per.shape[0] // 2].mean()
        loss.backward()
        opt.step()
        return {"loss": loss.detach(), "grad_norm": loss.detach()}
    monkeypatch.setattr(loop, "_train_step", step)


def _alter(out):
    m0 = out["matches0"].clone()
    n = m0.shape[-1]
    m0[0, 0] = (m0[0, 0] + 1) % n if m0[0, 0] >= 0 else n // 2
    out = dict(out)
    out["matches0"] = m0
    return out


def altered_answer(monkeypatch):
    from mdgat_tpu_torch.models.mdgat import MDGAT
    forward = MDGAT.forward

    def patched(self, *args, **kwargs):
        return _alter(forward(self, *args, **kwargs))
    monkeypatch.setattr(MDGAT, "forward", patched)


FAULTS = [("fpfh-train-b64n512", unchanged_state),
          ("fpfh-train-b64n512", frozen_parameters),
          ("fpfh-train-b64n512", half_batch),
          ("msg-train-b32n512", unchanged_state),
          ("msg-train-b32n512", frozen_parameters),
          ("msg-train-b32n512", half_batch),
          ("fpfh-match-b64n256", altered_answer),
          ("msg-eval-b64n256", altered_answer)]


@pytest.fixture(scope="module")
def sound():
    return {}


def sound_run(cache, cell):
    if cell not in cache:
        cache[cell] = run_small(cell)
    return cache[cell]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_fault_is_not_correct(cell, fault, monkeypatch, sound):
    _, good = sound_run(sound, cell)
    fault(monkeypatch)
    _, bad = run_small(cell)
    assert not bad["correct"]
    limits = common.workload(cell)["limits"]
    assert any(bad["values"][k] > max(limits[k], good["values"][k])
               for k in limits), (bad["values"], good["values"])


@pytest.mark.parametrize("cell", ["fpfh-train-b64n512", "msg-train-b32n512",
                                  "fpfh-match-b64n256", "msg-eval-b64n256"])
def test_control_is_not_correct(cell, sound):
    from bench_gpu.calibrate import control_readings
    run, good = sound_run(sound, cell)
    ctrl, _ = control_readings(run, good, run.device)
    ok, _ = checks.judge(ctrl, run.workload["limits"])
    assert not ok, ctrl


def test_malloc_thresholds_are_fixed():
    assert common.fix_malloc()


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    out = subprocess.run(
        [sys.executable, "bench_gpu/run.py", "--workload",
         "fpfh-match-b64n256", "--seed", str(2 ** 31 + 3), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env=dict(os.environ))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
