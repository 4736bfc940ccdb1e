"""The seeded traffic: the frozen generator draws what the port's does, and
every seed gets the same multiset of cloud sizes."""

import numpy as np

from bench_gpu.harness import traffic

TR = {"generator": "moved_subset", "batch": 4, "sizes": [200, 256],
      "sizes_seed": 7, "pool": 3, "overlap": 0.7}


def test_synthetic_pair_is_the_ports_at_equal_sizes():
    from mdgat_tpu_torch.data.synthetic import make_synthetic_pair
    a = traffic.synthetic_pair(np.random.default_rng(5), 300, 300)
    b = make_synthetic_pair(np.random.default_rng(5), 300)
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_every_seed_gets_the_same_sizes():
    one, two = traffic.size_plan(TR, 1), traffic.size_plan(TR, 2 ** 31 + 9)
    assert one.shape == (3, 4, 2)
    assert sorted(one.reshape(-1, 2).tolist()) == \
        sorted(two.reshape(-1, 2).tolist())
    assert not np.array_equal(one, two)
    pools = traffic.pool_pairs(TR, 1)
    assert [[[len(p["kp0"]), len(p["kp1"])] for p in b] for b in pools] == \
        one.tolist()


def test_clouds_lie_around_valid_keypoints():
    host = {"keypoints0": np.full((2, 4, 3), 100.0, np.float32),
            "keypoints1": np.zeros((2, 4, 3), np.float32),
            "mask0": np.array([[1, 1, 0, 0], [1, 0, 0, 0]], bool),
            "mask1": np.ones((2, 4), bool)}
    host["keypoints0"][:, 2:] = -1000.0       # padding, never picked
    out = traffic.add_clouds(host, traffic.rng_for(3, 4), 512)
    assert out["cloud0"].shape == (2, 512, 8)
    assert out["cloud0"].dtype == np.float32
    assert np.abs(out["cloud0"][..., :3] - 100.0).max() < 10.0
