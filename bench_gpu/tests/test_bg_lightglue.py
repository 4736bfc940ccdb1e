"""LightGlue's configuration and cell (``architectures/lightglue.py``,
``configs/lightglue-fpfh.json``, ``workloads/lightglue-match-b16n2048.json``):
the benchmark's reference against the tests' reference
(``tests/lightglue_reference.py``) at float64, its state dict loading into
the port's net, a reduced cell through ``run.execute`` on the kernel
routes' twins, the work counts against a hand count, and, on the card
(marked ``card``), the kernels the cell's route launches."""

import copy
import json
import shutil
import sys
import time

import numpy as np
import pytest
import torch

from bench_gpu.harness import cells, common, reference, traffic, weights

CELL = "lightglue-match-b16n2048"
SMALL = dict(descriptor_dim=128, num_heads=2, L=2)


def _config(**model):
    cfg = copy.deepcopy(common.config("lightglue-fpfh"))
    cfg["model"].update(model)
    return cfg


def _run(cfg, sizes=(40, 120), batch=3, seed=2 ** 31 + 3):
    wl = copy.deepcopy(common.workload(CELL))
    wl["traffic"].update(batch=batch, pool=3, sizes=list(sizes),
                         sample_calls=2)
    wl.update(trace_iters=3, reference_block=2)
    run = cells.Run(CELL, wl, cfg, seed, 0.3, False, torch.device("cpu"),
                    time.perf_counter())
    return run


def _tests_reference(w, sizes, x):
    sys.path.insert(0, str(common.ROOT / "tests"))
    import lightglue_reference as R
    ref = R.LightGlue(sizes["descriptor_dim"], sizes["num_heads"],
                      sizes["L"], sizes["match_threshold"],
                      sizes["keypoint_scale"]).double()
    ref.load_state_dict(reference.cast_weights(w, torch.float64))
    with torch.no_grad():
        return ref(x["keypoints0"], x["keypoints1"], x["descriptors0"],
                   x["descriptors1"], x["mask0"], x["mask1"])


def test_bg_the_reference_is_the_tests_reference():
    run = _run(_config(**SMALL))
    host = cells.pad_pairs(traffic.pool_pairs(run.traffic, run.seed)[0])
    w = run.weights("cpu")
    x = cells.ref_inputs(run, host, "cpu", torch.float64, 1e-12)
    (dense, bin_row, bin_col), dec = run.arch.reference_match(
        w, run.sizes, x, reference.REFERENCE)
    scores, m0, m1, s0, s1 = _tests_reference(w, run.sizes, x)
    n, m = dense.shape[1:]
    valid = x["mask0"][:, :, None] & x["mask1"][:, None, :]
    assert (dense[valid] - scores[:, :n, :m][valid]).abs().max() < 1e-10
    assert (bin_col[x["mask0"]] - scores[:, :n, m][x["mask0"]]).abs().max() \
        < 1e-12
    assert (bin_row[x["mask1"]] - scores[:, n, :m][x["mask1"]]).abs().max() \
        < 1e-12
    for a, b in zip(dec, (m0, m1, s0, s1)):
        assert torch.allclose(a.double(), b.double(), rtol=0, atol=1e-12)
    assert int((m0 >= 0).sum()) > 0


def test_bg_the_state_dict_loads_into_the_program():
    from mdgat_tpu_torch.core.config import test_defaults
    from mdgat_tpu_torch.models.factory import build_model
    cfg = common.config("lightglue-fpfh")
    arch = common.architecture(cfg)
    model = build_model(test_defaults(**arch.program_fields(cfg)))
    w = weights.make_weights(cfg, 2 ** 31 + 5, "cpu", arch)
    model.load_state_dict(w, strict=True)
    gain = cfg["weights"]["final_proj_gain"]
    last = w["log_assignment.8.final_proj.weight"]
    assert last.abs().max() <= gain / 16 and last.abs().max() > 1 / 16
    assert w["log_assignment.7.final_proj.weight"].abs().max() <= 1 / 16
    z_gain = cfg["weights"]["matchability_gain"]
    z = w["log_assignment.8.matchability.weight"].abs().max()
    assert z_gain / 32 < z <= z_gain / 16
    assert w["log_assignment.8.matchability.bias"].abs().max() <= z_gain / 16
    assert w["log_assignment.7.matchability.weight"].abs().max() > z_gain / 16
    wr = w["posenc.Wr.weight"]
    assert wr.shape == (32, 3) and 0.3 < float(wr.std()) < 2.0


def test_bg_a_reduced_cell_runs_on_the_twins(tmp_path):
    """The cell at D 128, 2 heads, 2 layers, 3 ragged pairs of 40-120 on
    the CPU twins, through ``run.execute``: correct under the cell's own
    limits."""
    from bench_gpu.run import execute
    folder = tmp_path / "bench_gpu"
    shutil.copytree(common.PKG / "architectures", folder / "architectures")
    shutil.copytree(common.PKG / "metrics", folder / "metrics")
    (folder / "configs").mkdir()
    (folder / "workloads").mkdir()
    cfg = _config(**SMALL)
    (folder / "configs" / "lightglue-fpfh.json").write_text(json.dumps(cfg))
    wl = copy.deepcopy(common.workload(CELL))
    wl["traffic"].update(batch=6, pool=3, sizes=[40, 120], sample_calls=2)
    wl.update(trace_iters=3, reference_block=3)
    (folder / "workloads" / f"{CELL}.json").write_text(json.dumps(wl))
    shutil.copy(common.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    code, out = execute(CELL, 2 ** 31 + 11, 0.3, False, "cpu",
                        overrides={"kernel_twins": True}, folder=folder)
    assert code == 0
    result, checks = out
    assert result["correct"], checks
    assert set(checks) == {"score_err", "decide_gap"}
    assert set(result["metrics"]) == {"match_pairs_per_s", "match_p95_ms",
                                      "peak_gib", "setup_s"}
    code, out = execute(CELL, 2 ** 31 + 11, 0.3, True, "cpu",
                        overrides={"kernel_twins": True}, folder=folder)
    assert code == 0 and out[0]["correct"]
    # a trace of the host alone: only the host span's metric reads
    assert set(out[0]["metrics"]) == {"host_ms.match"}


def test_bg_work_counts_by_hand():
    cfg = common.config("lightglue-fpfh")
    run = _run(cfg, sizes=(1536, 2048), batch=16)
    host = cells.pad_pairs(traffic.pool_pairs(run.traffic, run.seed)[0])
    got = run.arch.work(run.sizes, host, False)
    n0 = host["mask0"].sum(1).astype(np.float64)
    n1 = host["mask1"].sum(1).astype(np.float64)
    d = 256.0
    rows = n0.sum() + n1.sum()
    # a keypoint's linear layers a layer: Wqkv, out_proj, ffn (self);
    # to_qk + to_v, to_out, ffn (cross)
    per_row = 2 * (d * 3 * d + d * d + 4 * d * d + 2 * d * d) \
        + 2 * (2 * d * d + d * d + 4 * d * d + 2 * d * d)
    attention = 9 * ((4 * n0 * n0 * d).sum() + (4 * n1 * n1 * d).sum()
                     + (6 * n0 * n1 * d).sum())
    flops = (2 * rows * 33 * d + 2 * rows * 3 * 32 + 9 * rows * per_row
             + attention + 2 * rows * d * (d + 1) + (2 * n0 * n1 * d).sum())
    assert got["pairs"] == 16.0
    assert got["flops"] == pytest.approx(flops, rel=1e-12)
    # at 1536-2048 keypoints every call is bound by its operations
    assert got["lg_attention_bound_s"] == pytest.approx(attention / 67e12,
                                                        rel=1e-12)
    assert got["lg_assign_bound_s"] == pytest.approx(
        (2 * n0 * n1 * d).sum() / 67e12, rel=1e-12)
    # the linear layers: the 3.35 TB/s bound of the narrow input_proj
    # beside the operations of the rest
    lin = 9 * rows * per_row + 2 * rows * d * (d + 1)
    inp = [max(4 * (n * 33 + 33 * d + d + n * d) / 3.35e12,
               2 * n * 33 * d / 67e12) for n in (n0.sum(), n1.sum())]
    assert got["gemm_bound_s"] == pytest.approx(lin / 67e12 + sum(inp),
                                                rel=1e-9)
    # the attention's share of the work (59% at 2048 against 2048)
    assert 0.54 < attention / got["flops"] < 0.59


@pytest.mark.card
def test_bg_the_cells_route_launches_the_kernels_on_the_card():
    """On the card, one eager ``Matcher(net="lightglue")`` call at the
    configuration's widths launches each new kernel and ``gemm_kernel``
    as the route says, and holds to the benchmark's reference."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import mdgat_tpu_torch.api as api
    from mdgat_tpu_torch.ops.cuda import layer as layer_kernels
    from mdgat_tpu_torch.ops.cuda import lightglue as lgk
    cfg = common.config("lightglue-fpfh")
    run = _run(cfg, sizes=(300, 400), batch=4)
    run.device = torch.device("cuda")
    dev = run.device
    pairs = traffic.pool_pairs(run.traffic, run.seed)[0]
    matcher = api.Matcher(device=dev, seed=0, cuda_graphs=False,
                          **run.arch.program_fields(cfg))
    matcher.model.load_state_dict(run.weights(dev), strict=True)
    counters = (lgk.self_attention, lgk.cross_attention,
                lgk.layer_norm_gelu, lgk.assign, layer_kernels.gemm)
    before = [c.launches for c in counters]
    outs = matcher.match_batch(pairs)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == \
        [18, 9, 36, 1, 16 * 9 + 4]
    host = cells.pad_pairs(pairs)
    transport, _, masks, _ = cells.match_reference(
        run, host, dev, reference.REFERENCE, 1e-12)
    answers = cells._answers_from_pairs(outs, masks[0].shape[1],
                                        masks[1].shape[1], dev)
    got = run.arch.match_readings(run.sizes, answers, masks, transport)
    assert checks_ok(got, common.workload(CELL)["limits"]), got


def checks_ok(readings, limits):
    from bench_gpu.harness import checks
    return checks.judge(readings, limits)[0]
