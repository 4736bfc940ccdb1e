"""Port parity of the PointNet++ ops and the learned-descriptor encoders:
every function of ``mdgat_tpu_torch/ops/pointnet.py`` against
``mdgat_tpu/ops/pointnet.py`` at float64 on the CPU (indices exactly equal,
empty, short and full balls and masked FPS included; features to 1e-10
relative), and ``PointnetEncoder`` (SSG and MSG, MDGAT's and SuperGlue's
variant) against ``pointnet_encoder_apply`` in eval and train mode through
``state_dict_from_numpy``, the updated BN running stats included."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch import nn

from mdgat_tpu.models.pointnet_encoder import pointnet_encoder_apply
from mdgat_tpu.ops import pointnet as jp
from mdgat_tpu.ops.mlp import mlp_init, mlp_state_init

from mdgat_tpu_torch.core.checkpoint import state_dict_from_numpy
from mdgat_tpu_torch.ops import pointnet as pp
from mdgat_tpu_torch.ops.mlp import conv_bn_stack

from test_model import clouds_near_keypoints, tiny_batch
from test_torch_descriptor_modes import _setup

RTOL = 1e-10


def _t(a):
    return torch.from_numpy(np.array(a))


def _clouds(seed, b=2, n=24, points=160):
    """Keypoints [B, n, 3] and raw clouds [B, points, 8] clustered around
    them (real neighbours, some empty balls)."""
    rng = np.random.default_rng(seed)
    kpts = rng.normal(size=(2, b, n, 3)) * 4
    c0, c1 = clouds_near_keypoints(kpts[0], kpts[1], rng, n_points=points)
    return kpts[0], np.asarray(c0), kpts[1], np.asarray(c1)


def _ball_case(name):
    """One shape for every case (the JAX side compiles once): 2 clouds of
    60 points, 7 centers, 8 samples; the radius and centers make the balls
    random, empty (a center far away), short (fewer in-radius points than
    samples: backfilled) or full (every point inside)."""
    rng = np.random.default_rng(40)
    xyz, centers = rng.normal(size=(2, 60, 3)) * 3, rng.normal(size=(2, 7, 3)) * 3
    if name == "empty":
        centers[0, 0] = 100.0
        return xyz, centers, 2.0, 8
    if name == "short":
        return xyz, xyz[:, ::9] + 0.1, 1.2, 8
    return xyz, centers, {"random": 2.0, "full": 100.0}[name], 8


@pytest.mark.parametrize("case", ["random", "empty", "short", "full"])
def test_ball_query_and_gather_equal_the_jax_ops(case):
    xyz, centers, radius, nsample = _ball_case(case)
    got = pp.ball_query(_t(xyz), _t(centers), radius, nsample)
    want = np.asarray(jp.ball_query(jnp.asarray(xyz), jnp.asarray(centers),
                                    radius, nsample))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    n = xyz.shape[1]
    if case == "empty":
        assert (want[0, 0] == n).all() and (want[0, 1:] < n).any()
    if case == "short":
        assert ((want == want[..., :1]).sum(-1) > 1).any()   # backfilled
    if case == "full":
        assert (want == np.arange(8)).all()
    feats = np.random.default_rng(41).normal(size=xyz.shape[:2] + (5,))
    for pts in (xyz, feats):
        g = pp.gather_zero_sentinel(_t(pts), got).numpy()
        w = np.asarray(jp.gather_zero_sentinel(jnp.asarray(pts),
                                               jnp.asarray(want)))
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=0)
        assert (g[want == n] == 0).all()


@pytest.mark.parametrize("masked", [False, True])
def test_farthest_point_sample_equals_the_jax_op(masked):
    rng = np.random.default_rng(42)
    xyz = rng.normal(size=(3, 90, 3)) * 10
    start = np.array([0, 17, 55])
    mask = None
    if masked:
        mask = np.arange(90)[None, :] < np.array([90, 40, 70])[:, None]
    got = pp.farthest_point_sample(
        _t(xyz), 16, _t(start), None if mask is None else _t(mask)).numpy()
    want = np.asarray(jp.farthest_point_sample(
        jnp.asarray(xyz), 16, jnp.asarray(start, jnp.int32),
        None if mask is None else jnp.asarray(mask)))
    np.testing.assert_array_equal(got, want)
    if masked:
        assert all((got[b] < [90, 40, 70][b]).all() for b in range(3))
    assert all(len(set(row.tolist())) == 16 for row in got)


def _stacks(seed, in_ch, widths_list):
    """JAX trees for one conv stack a width list, random BN affines and
    running stats, and the same weights in the port's modules."""
    rng = np.random.default_rng(seed)
    jparams, jstate, port = [], [], []
    for i, widths in enumerate(widths_list):
        ch = [in_ch] + list(widths)
        p = mlp_init(jax.random.PRNGKey(seed + i), ch, dtype=jnp.float64,
                     bn_on_last=True)
        s = mlp_state_init(ch, dtype=jnp.float64, bn_on_last=True)
        p = jax.tree.map(np.asarray, p)
        s = jax.tree.map(np.asarray, s)
        for layer, st in zip(p, s):
            c = layer["bn"]["scale"].shape[0]
            layer["bn"] = {"scale": rng.uniform(0.5, 1.5, c),
                           "bias": rng.normal(size=c) * 0.2}
            st.update(mean=rng.normal(size=c) * 0.3,
                      var=rng.uniform(0.5, 1.5, c))
        convs, bns = conv_bn_stack(ch, dtype=torch.float64)
        with torch.no_grad():
            for layer, st, conv, bn in zip(p, s, convs, bns):
                conv.weight.copy_(_t(layer["lin"]["w"].T[:, :, None, None]))
                conv.bias.copy_(_t(layer["lin"]["b"]))
                bn.weight.copy_(_t(layer["bn"]["scale"]))
                bn.bias.copy_(_t(layer["bn"]["bias"]))
                bn.running_mean.copy_(_t(st["mean"]))
                bn.running_var.copy_(_t(st["var"]))
        jparams.append(p)
        jstate.append(s)
        port.append((convs, bns))
    return jparams, jstate, port


def _assert_stacks_state(port, jstate):
    for (_, bns), states in zip(port, jstate):
        for bn, st in zip(bns, states):
            np.testing.assert_allclose(bn.running_mean.numpy(), st["mean"],
                                       rtol=RTOL, atol=1e-14)
            np.testing.assert_allclose(bn.running_var.numpy(), st["var"],
                                       rtol=RTOL, atol=1e-14)


def _set_train(port, train):
    for convs, bns in port:
        nn.ModuleList([convs, bns]).train(train)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("op", ["set_kpts_msg", "set_abstraction_all",
                                "set_abstraction_msg", "feature_propagation",
                                "sample_and_group"])
def test_set_ops_equal_the_jax_ops(op, train):
    kp0, c0, _, _ = _clouds(43)
    xyz, feats, kpts = c0[..., :3], c0[..., 3:], kp0
    j = lambda a: jnp.asarray(a)
    start = np.array([3, 11])
    if op == "set_kpts_msg":
        jpar, jst, port = _stacks(1, 8, [(16, 24), (16, 32)])
        _set_train(port, train)
        got = pp.set_kpts_msg(port, _t(xyz), _t(feats), _t(kpts),
                              [1.0, 2.0], [8, 16])
        want, new = jp.set_kpts_msg_apply(jpar, jst, j(xyz), j(feats),
                                          j(kpts), [1.0, 2.0], [8, 16], train)
    elif op == "set_abstraction_all":
        jpar, jst, port = _stacks(2, 8, [(16, 24)])
        _set_train(port, train)
        got = pp.set_abstraction_all(port[0], _t(xyz), _t(feats))
        want, new = jp.set_abstraction_all_apply(jpar[0], jst[0], j(xyz),
                                                 j(feats), train)
        new = [new]
    elif op == "set_abstraction_msg":
        jpar, jst, port = _stacks(3, 8, [(16, 24), (16, 32)])
        _set_train(port, train)
        centers, got = pp.set_abstraction_msg(
            port, _t(xyz), _t(feats), 24, [1.0, 2.0], [8, 16], _t(start))
        jc, want, new = jp.set_abstraction_msg_apply(
            jpar, jst, j(xyz), j(feats), 24, [1.0, 2.0], [8, 16], train,
            fps_start=j(start))
        np.testing.assert_array_equal(centers.numpy(), np.asarray(jc))
    elif op == "sample_and_group":
        jpar, jst, port = _stacks(4, 8, [(16, 24)])
        _set_train(port, train)
        centers, got = pp.sample_and_group(port[0], _t(xyz), _t(feats), 24,
                                           1.0, 8, _t(start))
        jc, want, new = jp.sample_and_group_apply(
            jpar[0], jst[0], j(xyz), j(feats), 24, 1.0, 8, train,
            fps_start=j(start))
        np.testing.assert_array_equal(centers.numpy(), np.asarray(jc))
        new = [new]
    else:   # feature_propagation: keypoints' features onto the cloud
        pts2 = np.random.default_rng(44).normal(size=kpts.shape[:2] + (6,))
        jpar, jst, port = _stacks(5, 5 + 6, [(16, 24)])
        _set_train(port, train)
        got = pp.feature_propagation(port[0], _t(xyz), _t(kpts), _t(feats),
                                     _t(pts2))
        want, new = jp.feature_propagation_apply(
            jpar[0], jst[0], j(xyz), j(kpts), j(feats), j(pts2), train)
        new = [new]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=1e-12)
    _assert_stacks_state(port, new if train else jst)
    if op == "feature_propagation":   # one source point: a broadcast
        one = np.random.default_rng(49).normal(size=(2, 1, 11))
        got = pp.feature_propagation(port[0], _t(xyz), _t(kpts[:, :1]), None,
                                     _t(one))
        want, _ = jp.feature_propagation_apply(
            jpar[0], new[0] if train else jst[0], j(xyz), j(kpts[:, :1]),
            None, j(one), train)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("descriptor,net", [
    ("pointnet", "mdgat"), ("pointnetmsg", "mdgat"),
    ("pointnet", "superglue"), ("pointnetmsg", "superglue")])
def test_pointnet_encoder_equals_the_jax_encoder(descriptor, net, train):
    """Both clouds in turn (cloud 0 then cloud 1, the state threaded), as
    the model calls the encoder: outputs to 1e-10 relative, and after the
    train-mode calls every running statistic of ``penc``."""
    cfg, pcfg, params, state, model = _setup(descriptor, net)
    kp0, c0, kp1, c1 = _clouds(46)
    scores = np.random.default_rng(47).uniform(10, 20, size=(2, 2, 24))
    model.train(train)
    msg, sg = descriptor == "pointnetmsg", net == "superglue"
    jst = state["penc"]
    for kp, cloud, sc in ((kp0, c0, scores[0]), (kp1, c1, scores[1])):
        got = model.penc(_t(cloud), _t(kp), _t(sc))
        want, jst = pointnet_encoder_apply(
            params["penc"], jst, jnp.asarray(cloud), jnp.asarray(kp),
            jnp.asarray(sc), msg=msg, train=train, superglue=sg)
        assert got.shape == (2, 24, 32)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=RTOL, atol=1e-12)
    before = state_dict_from_numpy(params, state, pcfg)
    want_sd = state_dict_from_numpy(
        params, dict(state, penc=jax.tree.map(np.asarray, jst)), pcfg)
    got_sd = model.state_dict()
    stats = [k for k in want_sd if k.startswith("penc.") and "running_" in k]
    assert len(stats) >= 2 * (len(model.penc.spec["mlps"]) * 3 + 3)
    for key in stats:
        np.testing.assert_allclose(got_sd[key].numpy(), want_sd[key].numpy(),
                                   rtol=RTOL, atol=1e-14, err_msg=key)
    moved = [k for k in stats if not torch.equal(got_sd[k], before[k])]
    assert len(moved) == (len(stats) if train else 0)


def test_mdgat_pointnet_forward_on_tiny_batch_is_finite():
    """The JAX package's own smoke input (``tiny_batch`` with random clouds)
    through the port's train forward."""
    cfg, pcfg, params, state, model = _setup("pointnet", "mdgat")
    batch = {k: _t(v) for k, v in tiny_batch(cfg, b=2, n=24, m=24).items()}
    rng = np.random.default_rng(48)
    batch["cloud0"] = _t(rng.normal(size=(2, 128, 8)) * 5)
    batch["cloud1"] = _t(rng.normal(size=(2, 128, 8)) * 5)
    model.train()
    out = model(batch)
    assert out["loss"].shape == (2,) and torch.isfinite(out["loss"]).all()
