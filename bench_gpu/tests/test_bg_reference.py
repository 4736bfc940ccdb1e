"""The frozen reference against the port's own routes, at float64 on the
CPU at a tiny size: the plain route (``use_kernels=False``, exact top-k)
and the kernel routes' twins (``kernel_twins``, the value bisection at
float64's resolution). The reference imports nothing of the port; only
this test puts the two side by side."""

import copy
import time

import pytest
import torch

from bench_gpu.harness import cells, common, reference

F64_BISECTION = 14     # the value bisection's resolution for float64


def tiny_run(cell, seed=3, n=(140, 150), train_n=160, points=512):
    wl = copy.deepcopy(common.workload(cell))
    tr = wl["traffic"]
    tr.update(batch=2, pool=3)
    if wl["kind"] == "train":
        tr.update(sizes=[train_n, train_n], max_keypoints=train_n)
    else:
        tr["sizes"] = list(n)
    if tr.get("cloud_points"):
        tr["cloud_points"] = points
    wl["reference_block"] = 2
    return cells.Run(cell, wl, common.config(wl["config"]), seed, 1.0, False,
                     torch.device("cpu"), time.perf_counter())


def program(run, train, **fields):
    from mdgat_tpu_torch.models.mdgat import MDGAT
    cfg = cells.program_config(run, "train" if train else "eval").replace(
        compute_dtype="float64", param_dtype="float64", **fields)
    model = MDGAT(cfg)
    w = reference.cast_weights(run.weights("cpu"),
                               torch.float64)
    model.load_state_dict(w, strict=True)
    return model.train(train), cfg


def host_batch(run):
    if run.workload["kind"] == "train":
        return cells.train_hosts(run)[0]
    return cells.eval_hosts(run)[0]


def prepared(host, cfg):
    from mdgat_tpu_torch.data.pipeline import model_inputs, prepare_batch
    return model_inputs(prepare_batch(host, cfg.threshold, cfg.mutual_check,
                                      "cpu", torch.float64, torch.float64))


ROUTES = [pytest.param({"use_kernels": False}, 0, id="plain"),
          pytest.param({"kernel_twins": True}, F64_BISECTION, id="twins")]
# the eval kernel route prepares its layers' weights in float32
# (ops/cuda/layer.py::prepare_layer_weights), its twins too: their
# transport agrees to float32's rounding of the weights, not float64's
TOL = 1e-6
# the port normalises the float32 descriptors in float32 before the cast
# to float64 (data/pipeline.py::prepare_batch), the reference in float64:
# a training step agrees to that rounding
TRAIN_REL = 1e-6


@pytest.mark.parametrize("config", ["mdgat-fpfh", "mdgat-pointnetmsg"])
@pytest.mark.parametrize("fields,fine", ROUTES)
def test_eval_transport(config, fields, fine):
    run = tiny_run("msg-eval-b64n256")
    run.config = common.config(config)
    host = host_batch(run)
    model, cfg = program(run, False, **fields)
    with torch.no_grad():
        out = model(prepared(host, cfg), return_full_scores=True)
    x = cells.ref_inputs(run, host, "cpu", torch.float64)
    P = reference.cast_weights(run.weights("cpu"),
                               torch.float64)
    dense, bin_row, bin_col = reference.transport(
        P, run.sizes, x, False, fine, reference.REFERENCE)
    full = out["scores"]
    m0, m1 = x["mask0"], x["mask1"]
    both = m0[:, :, None] & m1[:, None, :]
    assert torch.allclose(full[:, :-1, :-1][both], dense[both], rtol=TOL,
                          atol=TOL)
    assert torch.allclose(full[:, :-1, -1][m0], bin_col[m0], rtol=TOL,
                          atol=TOL)
    assert torch.allclose(full[:, -1, :-1][m1], bin_row[m1], rtol=TOL,
                          atol=TOL)
    r0, r1, s0, s1 = reference.decide(dense, bin_row, bin_col, m0, m1)
    assert torch.equal(out["matches0"].long(), r0)
    assert torch.equal(out["matches1"].long(), r1)
    assert torch.allclose(out["matching_scores0"], s0, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("cell", ["fpfh-train-b64n512", "msg-train-b32n512"])
@pytest.mark.parametrize("fields,fine", ROUTES)
def test_train_loss_and_gradients(cell, fields, fine):
    run = tiny_run(cell)
    host = host_batch(run)
    model, cfg = program(run, True, **fields)
    batch = prepared(host, cfg)
    loss = model(batch)["loss"].mean()
    loss.backward()
    x = cells.ref_inputs(run, host, "cpu", torch.float64)
    assert torch.equal(batch["gt_matches0"].long(), x["gt0"])
    assert torch.equal(batch["gt_matches1"].long(), x["gt1"])
    losses, grads, _ = reference.train(
        run.weights("cpu"), run.sizes, [x], fine,
        reference.REFERENCE, 1e-4)
    assert losses[0] == pytest.approx(float(loss.detach()), rel=TRAIN_REL)
    named = dict(model.named_parameters())
    scale = max(float(g.abs().max()) for g in grads.values())
    for name, g in grads.items():
        assert torch.allclose(named[name].grad, g, rtol=100 * TRAIN_REL,
                              atol=100 * TRAIN_REL * scale), name


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      1.0 + 2 ** -12, -(1.0 + 3 * 2 ** -11), 3.0e-3])
    r = reference.round_tf32(x)
    # ties go to even: 1 + 2^-11 -> 1, 1 + 3 * 2^-11 -> 1 + 2^-9
    assert r[0] == 1.0 and r[1] == 1.0 and r[2] == 1.0 + 2 ** -9
    assert r[3] == 1.0 and r[4] == -(1.0 + 2 ** -9)
    assert abs(float(r[5]) / 3.0e-3 - 1) <= 2 ** -11


def test_tf32_product_gradients():
    a = torch.randn(3, 5, 7, dtype=torch.float32, requires_grad=True)
    b = torch.randn(7, 4, dtype=torch.float32, requires_grad=True)
    out = reference.mm(a, b, reference.CONTROL)
    want = reference.round_tf32(a) @ reference.round_tf32(b)
    assert torch.equal(out, want)
    out.sum().backward()
    g = torch.ones(3, 5, 4)
    assert torch.allclose(a.grad, g @ reference.round_tf32(b).t())
    assert torch.allclose(b.grad, (reference.round_tf32(a).transpose(1, 2)
                                   @ g).sum(0))
