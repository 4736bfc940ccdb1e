"""LightGlue in the port (``models/lightglue.py``) against the plain
reference ``tests/lightglue_reference.py`` (upstream's ``lightglue.py`` in
plain torch, importing nothing of the port), on seeded weights at a small
size (D 128, 2 heads of 64, 2 layers, 40-200 ragged keypoints), float64 on
the CPU: the plain route and the kernel routes' twins (``kernel_twins``),
the decision's cases, padding, the state dict's names, ``Matcher`` end to
end, the graph gate, and the refusals. The kernels' launches on the card:
``bench_gpu/tests/test_bg_lightglue.py`` (marked ``card``)."""

import numpy as np
import pytest
import torch

import lightglue_reference as R
from mdgat_tpu_torch import Matcher
from mdgat_tpu_torch.core.config import test_defaults as eval_defaults
from mdgat_tpu_torch.core.config import train_defaults
from mdgat_tpu_torch.models.factory import build_model
from mdgat_tpu_torch.models.lightglue import LightGlue
from mdgat_tpu_torch.ops.matching import filter_matches
from mdgat_tpu_torch.ops.cuda import lightglue as lgk
from mdgat_tpu_torch.train import create_train_state
from mdgat_tpu_torch.utils import graphs
from mdgat_tpu_torch.utils.graphs import use_graphs

from test_torch_graphs import StandIn

D, H, L = 128, 2, 2
# the final projection scaled so that seeded weights match a share of the
# keypoints (as the benchmark's configuration scales it)
GAIN = 4.0
THRESHOLD = 0.02
SMALL = dict(net="lightglue", descriptor_dim=D, num_heads=H, L=L,
             match_threshold=THRESHOLD, compute_dtype="float64",
             param_dtype="float64")
ROUTES = [pytest.param({"use_kernels": False}, id="plain"),
          pytest.param({"kernel_twins": True}, id="twins")]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _state(seed=6):
    model = LightGlue(eval_defaults(**SMALL))
    model.reset_parameters(seed)
    sd = model.state_dict()
    for k in (f"log_assignment.{L - 1}.final_proj.weight",
              f"log_assignment.{L - 1}.final_proj.bias"):
        sd[k] = sd[k] * GAIN
    return sd


def _pair(rng, n0, n1, overlap=0.7):
    """Cloud 1 a moved, noisy subset of cloud 0 plus fresh points."""
    kp0 = rng.uniform(-30, 30, size=(n0, 3))
    d0 = np.abs(rng.normal(size=(n0, 33)))
    s = int(overlap * min(n0, n1))
    th = rng.uniform(-0.3, 0.3)
    rot = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                    [0, 0, 1]])
    kp1 = np.concatenate([kp0[:s] @ rot.T + rng.normal(size=3),
                          rng.uniform(-30, 30, size=(n1 - s, 3))])
    d1 = np.concatenate([d0[:s] + 0.05 * rng.normal(size=(s, 33)),
                         np.abs(rng.normal(size=(n1 - s, 33)))])
    return {"kp0": kp0, "desc0": d0, "kp1": kp1, "desc1": np.abs(d1)}


def _batch(pairs):
    """The pairs padded to the largest, descriptors L2-normalised, f64."""
    out = {}
    for side in "01":
        n = max(len(p["kp" + side]) for p in pairs)
        kp = torch.zeros(len(pairs), n, 3, dtype=torch.float64)
        de = torch.zeros(len(pairs), n, 33, dtype=torch.float64)
        mk = torch.zeros(len(pairs), n, dtype=torch.bool)
        for i, p in enumerate(pairs):
            k = len(p["kp" + side])
            kp[i, :k] = torch.as_tensor(p["kp" + side])
            d = torch.as_tensor(p["desc" + side])
            de[i, :k] = d / d.norm(dim=-1, keepdim=True)
            mk[i, :k] = True
        out.update({"keypoints" + side: kp, "descriptors" + side: de,
                    "mask" + side: mk})
    return out


def _reference(sd, x):
    ref = R.LightGlue(D, H, L, THRESHOLD, 30.0).double()
    ref.load_state_dict(sd, strict=True)
    with torch.no_grad():
        return ref(x["keypoints0"], x["keypoints1"], x["descriptors0"],
                   x["descriptors1"], x["mask0"], x["mask1"])


def _port(sd, **fields):
    model = build_model(eval_defaults(**SMALL, **fields))
    model.load_state_dict(sd, strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(7)
    pairs = [_pair(rng, 200, 160), _pair(rng, 40, 90), _pair(rng, 130, 200)]
    sd = _state()
    x = _batch(pairs)
    return pairs, sd, x, _reference(sd, x)


def test_state_dict_keys_are_upstreams():
    sd = _state()
    ref = R.LightGlue(D, H, L).double()
    assert sorted(sd) == sorted(ref.state_dict())
    assert {"input_proj.weight", "posenc.Wr.weight",
            "transformers.0.self_attn.Wqkv.weight",
            "transformers.1.self_attn.ffn.3.bias",
            "transformers.0.cross_attn.to_qk.weight",
            "transformers.1.cross_attn.ffn.1.weight",
            f"log_assignment.{L - 1}.matchability.bias",
            "token_confidence.0.token.0.weight"} <= set(sd)
    assert "confidence_thresholds" not in sd
    assert sd["posenc.Wr.weight"].shape == (D // H // 2, 3)


@pytest.mark.parametrize("fields", ROUTES)
def test_routes_hold_to_the_reference(case, fields):
    """The inner block and dustbins of the final descriptors, matches and
    scores: float64 on both sides, so to rounding."""
    _, sd, x, (scores, m0, m1, s0, s1) = case
    with torch.no_grad():
        out = _port(sd, **fields)(x, return_full_scores=True)
    b, n, m = x["mask0"].shape[0], x["mask0"].shape[1], x["mask1"].shape[1]
    valid = torch.zeros(b, n + 1, m + 1, dtype=torch.bool)
    valid[:, :n, :m] = x["mask0"][:, :, None] & x["mask1"][:, None, :]
    valid[:, :n, m], valid[:, n, :m] = x["mask0"], x["mask1"]
    assert (out["scores"][valid] - scores[valid]).abs().max() < 1e-10
    assert torch.equal(out["matches0"], m0)
    assert torch.equal(out["matches1"], m1)
    assert (out["matching_scores0"] - s0).abs().max() < 1e-12
    assert (out["matching_scores1"] - s1).abs().max() < 1e-12
    assert int((m0 >= 0).sum()) >= 20          # the decision has work


@pytest.mark.parametrize("fields", ROUTES)
def test_a_padded_batch_equals_each_pair_alone(case, fields):
    pairs, sd, x, _ = case
    model = _port(sd, **fields)
    with torch.no_grad():
        whole = model(x)
        for i, p in enumerate(pairs):
            alone = model(_batch([p]))
            n0, n1 = len(p["kp0"]), len(p["kp1"])
            assert torch.equal(alone["matches0"][0], whole["matches0"][i, :n0])
            assert torch.equal(alone["matches1"][0], whole["matches1"][i, :n1])
            for k, n in (("matching_scores0", n0), ("matching_scores1", n1)):
                assert torch.allclose(alone[k][0], whole[k][i, :n],
                                      rtol=0, atol=1e-12)
            assert (whole["matches0"][i, n0:] == -1).all()
            assert (whole["matching_scores1"][i, n1:] == 0).all()


def test_decision_mutual_and_threshold_cases():
    """A crafted inner block: row 0 and column 1 mutual above the
    threshold; row 1's best is column 1, whose best is row 0 (not
    mutual); row 2 ties columns 0 and 2 (the first wins) and is mutual
    exactly at the threshold (``exp(score) > th`` fails); a padded row
    and column never match."""
    t = torch.tensor
    inner = t([[[-3.0, -0.2, -5.0, -9.0],
                [-4.0, -0.5, -6.0, -9.0],
                [-1.0, -7.0, -1.0, -9.0],
                [-0.1, -0.1, -0.1, -0.1]]], dtype=torch.float64)
    mask0 = t([[True, True, True, False]])
    mask1 = t([[True, True, True, False]])
    th = float(torch.exp(t(-1.0, dtype=torch.float64)))
    m0, m1, s0, s1 = filter_matches(inner, th, mask0, mask1)
    assert m0.tolist() == [[1, -1, -1, -1]]
    assert m1.tolist() == [[-1, 0, -1, -1]]
    # row 2 is mutual with column 0: its score is reported, unmatched
    assert s0[0, 2] == th and s1[0, 0] == th
    assert s0[0, 1] == 0 and s0[0, 3] == 0 and s1[0, 3] == 0
    assert abs(s0[0, 0] - np.exp(-0.2)) < 1e-15
    r = R.filter_matches(torch.nn.functional.pad(inner, (0, 1, 0, 1)), th,
                         mask0, mask1)
    for a, b in zip(r, (m0, m1, s0, s1)):
        assert torch.equal(a, b)


def test_assignment_twin_agrees_with_the_plain_assignment_and_its_ties():
    """The assignment kernels' twin on a random final projection: the
    plain route's inner block and decision, and a row exactly at the
    threshold unmatched (each at its own rounding of the score)."""
    g = torch.Generator().manual_seed(3)
    b, n, m, d = 2, 70, 90, 64
    md0 = torch.randn(b, n, d + lgk.ASSIGN_PAD, generator=g,
                      dtype=torch.float64)
    md1 = torch.randn(b, m, d + lgk.ASSIGN_PAD, generator=g,
                      dtype=torch.float64)
    md1[:, :40, :d] = md0[:, :40, :d] + 0.05 * torch.randn(
        b, 40, d, generator=g, dtype=torch.float64)
    mask0 = torch.ones(b, n, dtype=torch.bool)
    mask1 = torch.ones(b, m, dtype=torch.bool)
    mask0[1, 60:], mask1[0, 75:] = False, False
    got = lgk.assign_reference(md0, md1, mask0, mask1, d, 0.0,
                               return_block=True)
    sim = md0[..., :d] @ md1[..., :d].transpose(1, 2)
    valid = mask0[:, :, None] & mask1[:, None, :]
    s = sim.masked_fill(~valid, -np.inf)
    inner = (torch.log_softmax(s, 2) + torch.log_softmax(s, 1)
             + torch.nn.functional.logsigmoid(md0[..., d])[:, :, None]
             + torch.nn.functional.logsigmoid(md1[..., d])[:, None, :])
    assert (got[4][valid] - inner[valid]).abs().max() < 1e-12
    plain = filter_matches(inner, 0.0, mask0, mask1)
    assert all(torch.equal(a, c) for a, c in zip(got[:2], plain[:2]))
    matched = (got[0] >= 0).nonzero()
    assert len(matched) >= 20
    p, i = matched[0].tolist()
    # each at exactly its own score of that row: unmatched, score kept
    th = float(got[2][p, i])
    at = lgk.assign_reference(md0, md1, mask0, mask1, d, th)
    assert at[0][p, i] == -1 and at[2][p, i] == th
    assert at[1][p, got[0][p, i]] == -1
    th = float(plain[2][p, i])
    assert filter_matches(inner, th, mask0, mask1)[0][p, i] == -1


def test_matcher_serves_and_registers(case, tmp_path):
    pairs, sd, _, (_, m0, _, s0, _) = case
    path = str(tmp_path / "lightglue.pth")
    torch.save(sd, path)
    matcher = Matcher(path, device="cpu", **SMALL, kernel_twins=True)
    outs = matcher.match_batch(pairs)
    for i, (p, out) in enumerate(zip(pairs, outs)):
        n0 = len(p["kp0"])
        assert out["matches0"].shape == (n0,)
        assert out["matching_scores1"].shape == (len(p["kp1"]),)
        np.testing.assert_array_equal(out["matches0"], m0[i, :n0].numpy())
        np.testing.assert_allclose(out["matching_scores0"],
                                   s0[i, :n0].numpy(), rtol=1e-6, atol=0)
    reg = matcher.register(**{k: pairs[0][k]
                              for k in ("kp0", "desc0", "kp1", "desc1")})
    assert reg["n_matches"] == int((m0[0] >= 0).sum()) >= 4
    assert reg["T"].shape == (4, 4) and reg["inliers"] >= 3
    grid = Matcher(path, device="cpu", **SMALL, data_parallel=2,
                   kernel_twins=True)
    for a, b in zip(outs, grid.match_batch(pairs)):
        np.testing.assert_array_equal(a["matches0"], b["matches0"])
        np.testing.assert_array_equal(a["matching_scores1"],
                                      b["matching_scores1"])


def test_kernel_route_goes_through_the_wrappers(case, monkeypatch):
    """On the CPU the kernel route calls each wrapper (their twins): per
    forward 2L self-attentions, L cross-attentions, 4L LayerNorm + GELU, 1
    assignment; the plain route none."""
    _, sd, x, _ = case
    calls = {}
    for name in ("self_attention", "cross_attention", "layer_norm_gelu",
                 "assign", "linear"):
        fn = getattr(lgk, name)

        def spy(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(lgk, name, spy)
    with torch.no_grad():
        _port(sd, use_kernels=False)(x)
        assert calls == {}
        _port(sd, kernel_twins=True)(x)
    assert calls == {"self_attention": 2 * L, "cross_attention": L,
                     "layer_norm_gelu": 4 * L, "assign": 1,
                     "linear": 16 * L + 4}


def test_graph_gate_captures_lightglue_above_1024_and_not_mdgat(monkeypatch):
    monkeypatch.setattr(graphs, "BACKEND", StandIn())
    big = {"keypoints0": torch.zeros(1, 2048, 3),
           "keypoints1": torch.zeros(1, 2048, 3)}
    lg = eval_defaults(net="lightglue")
    assert LightGlue.captures_any_size
    assert use_graphs(lg, "cpu", big, LightGlue.captures_any_size)
    assert not use_graphs(lg, "cpu", big)
    assert not use_graphs(eval_defaults(), "cpu", big)
    assert not use_graphs(eval_defaults(net="superglue"), "cpu", big)
    assert not any(getattr(build_model(eval_defaults(net=net, descriptor_dim=64,
                                                     L=1)),
                           "captures_any_size", False)
                   for net in ("mdgat", "superglue", "raw"))
    small = {k: v[:, :1024] for k, v in big.items()}
    assert use_graphs(eval_defaults(), "cpu", small)
    # a Matcher at 2048 keypoints: warm-up, capture, replays
    rng = np.random.default_rng(1)
    pairs = [_pair(rng, 2048, 1900)]
    m = Matcher(device="cpu", seed=1, net="lightglue", descriptor_dim=64,
                num_heads=1, L=1, kernel_twins=True)
    outs = [m.match_batch(pairs) for _ in range(3)]
    cap = m._step.graphs[0]
    assert (cap.warm_ups, cap.captures, cap.replays) == (1, 1, 2)
    for o in outs[1:]:
        np.testing.assert_array_equal(o[0]["matches0"], outs[0][0]["matches0"])


def test_training_and_a_seq_axis_refuse_lightglue():
    with pytest.raises(ValueError, match="lightglue"):
        create_train_state(train_defaults(net="lightglue"), device="cpu",
                           seed=0)
    with pytest.raises(ValueError, match="lightglue"):
        Matcher(device="cpu", seed=0, net="lightglue", seq_parallel=2)
    # adaptive depth and width are not ported: no option turns them on
    for name in ("depth_confidence", "width_confidence"):
        with pytest.raises(TypeError, match=name):
            eval_defaults(net="lightglue", **{name: 0.95})
    import train_torch
    with pytest.raises(ValueError, match="lightglue"):
        train_torch.main(["--net", "lightglue", "--device", "cpu"])
