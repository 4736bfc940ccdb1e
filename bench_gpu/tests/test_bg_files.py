"""The benchmark's files agree with each other and with the schema of
``BENCHMARK.json``: every cell names a configuration and a traffic file
that exist, every per-layer metric has its reader and its cells report
the metric it moves, every configuration file holds what the program is
run with."""

import dataclasses
import json
import re

import pytest

from bench_gpu.harness import common, reference

BENCH = common.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench_gpu/run.py"]
    assert BENCH["paths"] == ["bench_gpu"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert entry["chips"] == 1 and len(entry["why"]) <= 200
    wl = common.workload(entry["traffic"])
    assert wl["config"] == entry["config"]
    assert wl["kind"] in ("train", "match", "eval")
    assert any(c["name"] == wl["config"] for c in BENCH["configs"])
    cfg = common.config(wl["config"])
    assert wl["limits"]
    assert all(NAME.match(k) and v >= 0 for k, v in wl["limits"].items())
    # the numbers MDGAT's readings give; another architecture's readings
    # are its own module's
    if cfg.get("architecture", common.DEFAULT_ARCHITECTURE) == "mdgat":
        assert set(wl["limits"]) <= {"loss_gap", "grad_gap", "change_gap",
                                     "grad_med", "change_med", "gt_mismatch",
                                     "match_gap", "score_err"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports(cell):
    e2e = {m["name"] for m in common.end_to_end_for(cell, BENCH)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = common.per_layer_for(cell, BENCH)
    assert layers
    for m in layers:
        assert m["moves"] in e2e, (cell, m["name"])


def test_per_layer_metrics_have_readers_and_layers():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert callable(common.metric_reader(m["name"]))
        assert set(m["workloads"]) <= set(CELLS)
        layers.setdefault(m["layer"], []).append(m["name"])
    assert set(layers) <= {"entry", "data path", "graph runtime", "model",
                           "kernels", "device"}


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert next(m for m in BENCH["end_to_end"]
                if m["name"] == "setup_s")["bound"] <= 0.25


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
    from mdgat_tpu_torch.core.config import Config
    cfg = common.load_json(common.ROOT / entry["file"])
    assert entry["file"] == f"bench_gpu/configs/{entry['name']}.json"
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    fields = {f.name for f in dataclasses.fields(Config)}
    assert set(cfg["model"]) <= fields
    # every program field the file states is the one the program runs
    # when given the file (tuples where Config keeps tuples)
    base = Config()
    for k, v in cfg["model"].items():
        if isinstance(getattr(base, k), tuple):
            v = tuple(v)
        assert getattr(base.replace(**{k: v}), k) == v


def test_msg_encoder_widths_are_the_programs():
    from mdgat_tpu_torch.models.pointnet_encoder import MSG_SPEC
    cfg = common.config("mdgat-pointnetmsg")["encoder"]
    assert list(MSG_SPEC["radius_list"]) == cfg["radius_list"]
    assert list(MSG_SPEC["nsample_list"]) == cfg["nsample_list"]
    assert [list(m) for m in MSG_SPEC["mlps"]] == cfg["mlps"]
    assert MSG_SPEC["in_channel"] == cfg["in_channel"]


@pytest.mark.parametrize("name", ["mdgat-fpfh", "mdgat-pointnetmsg"])
def test_weights_load_into_the_program(name):
    import torch
    from bench_gpu.harness.weights import make_weights
    from mdgat_tpu_torch.core.config import Config
    from mdgat_tpu_torch.models.mdgat import MDGAT
    cfg = common.config(name)
    arch = common.architecture(cfg)
    model = MDGAT(Config(descriptor=cfg["model"]["descriptor"]))
    w = make_weights(cfg, 2 ** 31 + 5, "cpu", arch)
    model.load_state_dict(w, strict=True)
    again = make_weights(cfg, 2 ** 31 + 5, "cpu", arch)
    assert all(torch.equal(w[k], again[k]) for k in w)
    other = make_weights(cfg, 2 ** 31 + 6, "cpu", arch)
    assert not torch.equal(w["final_proj.weight"], other["final_proj.weight"])
