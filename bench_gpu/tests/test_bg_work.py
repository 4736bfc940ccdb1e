"""The benchmark's work counts against hand-worked small shapes."""

import numpy as np
import pytest

from bench_gpu.harness import work
from bench_gpu.harness.reference import k_schedule

TINY = {"descriptor": "FPFH", "descriptor_dim": 4, "keypoint_encoder": [2],
        "descriptor_encoder": [3], "num_heads": 2, "L": 1, "k": [None, 2]}


def test_bound_takes_the_longer_of_bytes_and_operations():
    assert work.bound_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert work.bound_s(0.0, 67e12) == pytest.approx(1.0)
    assert work.bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)


def test_attention_forward_counts():
    n, m = np.array([2.0]), np.array([3.0])
    # scores 2*2*3*4 = 48, values over all 3 keys 48; q, o 2*4 each, k, v
    # 3*4 each, a row statistic 2*2, floats, and 3 mask bytes
    nbytes, flops = work.attention_fwd(n, m, None, 4, 2)
    assert flops == 96
    assert nbytes == 4 * (2 * 2 * 4 + 2 * 3 * 4 + 2 * 2) + 3
    # top-2: values over 2 kept keys a row, 2*2*2*4 = 32
    assert work.attention_fwd(n, m, 2, 4, 2)[1] == 48 + 32
    # a k above the valid keys keeps them all
    assert work.attention_fwd(n, m, 5, 4, 2)[1] == 96


def test_attention_backward_counts():
    n, m = np.array([2.0, 1.0]), np.array([3.0, 2.0])
    # scores once, four products over the kept entries (k = 2)
    want = (2 * 2 * 3 * 4 + 8 * 2 * 2 * 4) + (2 * 1 * 2 * 4 + 8 * 1 * 2 * 4)
    nbytes, flops = work.attention_bwd(n, m, 2, 4, 2)
    assert flops == want
    rows, keys = 3.0, 5.0
    assert nbytes == 4 * (3 * rows * 4 + 2 * rows * 2 + 2 * keys * 4
                          + rows * 4 + 2 * keys * 4) + keys


def test_layer_gemms():
    g = work.layer_gemms(np.array([10.0]), np.array([6.0]), 4)
    # q: 10 x 4 in, 4 x 4 weight, 4 bias, 10 x 4 out; 2*10*4*4 operations
    assert g[0] == (4 * (40 + 16 + 4 + 40), 320)
    assert g[1] == (4 * (24 + 16 + 4 + 24), 192)
    # the first MLP conv: 10 x 8 in, 8 x 8 weight, 8 bias, 10 x 8 out
    assert g[4] == (4 * (80 + 64 + 8 + 80), 2 * 10 * 8 * 8)
    # the second reads the residual too
    assert g[5] == (4 * (80 + 32 + 4 + 40) + 4 * 40, 2 * 10 * 8 * 4)


def test_conv_chain_training():
    # forward 2r(ab + bc); training adds both gradients but the first
    # layer's input gradient, its input being data
    r, ch = 5.0, [3, 4, 2]
    fwd = 2 * r * (3 * 4 + 4 * 2)
    assert work._chain(r, ch, True, False) == fwd
    assert work._chain(r, ch, True, True) == 3 * fwd - 2 * r * 3 * 4
    assert work._chain(r, ch, False, True) == 3 * fwd


def test_layer_calls_follow_the_schedule():
    shape = {"n0": np.array([3.0]), "n1": np.array([5.0]), "N": 8, "M": 8,
             "P": 0}
    calls = list(work.layer_calls(TINY, shape))
    # self then cross, each on cloud 0 then cloud 1; k = 2 on the cross
    assert [(float(n[0]), float(m[0]), k) for n, m, k in calls] == [
        (3, 3, None), (5, 5, None), (3, 5, 2), (5, 3, 2)]


def test_model_flops_by_hand():
    shape = {"n0": np.array([3.0]), "n1": np.array([5.0]), "N": 8, "M": 8,
             "P": 0}
    d = 4
    enc = lambda r: 2 * r * (4 * 2 + 2 * 4) + 2 * r * (33 * 3 + 3 * 4)  # noqa
    lin = lambda n, m: 2 * d * d * (2 * n + 2 * m) + 2 * n * (8 * 8 + 8 * 4)  # noqa
    att = lambda n, m, kept: 2 * n * m * d + 2 * n * kept * d  # noqa
    want = (enc(3) + enc(5) + lin(3, 3) + lin(5, 5) + lin(3, 5) + lin(5, 3)
            + att(3, 3, 3) + att(5, 5, 5) + att(3, 5, 2) + att(5, 3, 2)
            + 2 * 8 * d * d + 2 * 3 * 5 * d)
    assert work.model_flops(TINY, shape, False) == want


def test_shape_and_per_iteration():
    host = {"mask0": np.array([[1, 1, 0], [1, 0, 0]], bool),
            "mask1": np.array([[1, 1, 1], [1, 1, 0]], bool)}
    shape = work.shape_of(host)
    assert list(shape["n0"]) == [2, 1] and list(shape["n1"]) == [3, 2]
    assert (shape["N"], shape["M"], shape["P"]) == (3, 3, 0)
    s = [{"flops": 1.0}, {"flops": 10.0}]
    assert work.per_iteration(s, [0, 1, 1]) == {"flops": 21.0}
    assert work.per_iteration(s, []) is None


def test_k_schedule_is_the_programs():
    from mdgat_tpu_torch.core.config import Config
    cfg = Config()
    spec = {"L": cfg.L, "k": list(cfg.k)}
    for n in (64, 128, 129, 256, 512):
        assert k_schedule(spec, n) == cfg.layer_k_schedule(n)
