"""Seeded traffic: matched keypoint pairs, raw clouds, and the pools a cell
cycles through, all from one general generator that a workload file's
``traffic`` block drives.

Frozen copies of the port's generators, so that a later change to the
program cannot move the yardstick:

* :func:`synthetic_pair` is ``mdgat_tpu_torch/data/synthetic.py::
  make_synthetic_pair`` (two views of a latent world cloud under a known
  rigid motion, with jitter and descriptor noise), widened to two cloud
  sizes; at equal sizes it draws what the original draws, in its order;
* :func:`moved_subset_pair` is ``chip_smoke.py::make_pairs`` (cloud 1 a
  rigidly moved, noisy subset of cloud 0 plus fresh points), with the sizes
  passed in rather than drawn;
* :func:`add_clouds` is the host half of ``chip_smoke.py::with_clouds``
  (16384 x 8 raw clouds around each side's keypoints), drawing around the
  valid keypoints only.

Every seed gets the same multiset of cloud sizes (drawn once from
``sizes_seed``), in its own order, so that seeds change the data and not
the work. Stacked batches follow ``data/pipeline.py::collate_pairs``'s
layout; the shaping itself is the program's (``collate_pairs``), which the
cells call on these pairs.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy stream ``stream`` of a run's ``seed``."""
    return np.random.default_rng([int(seed) & (2 ** 63 - 1), int(stream)])


def _random_rotation(rng, max_angle_rad: float) -> np.ndarray:
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    ang = rng.uniform(-max_angle_rad, max_angle_rad)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * (K @ K)


def synthetic_pair(rng: np.random.Generator, n0: int, n1: int,
                   overlap: float = 0.7, jitter: float = 0.05,
                   desc_noise: float = 0.05,
                   extent: float = 30.0) -> Dict[str, np.ndarray]:
    """One matched pair with known pose ``T_gt`` (cloud 1 into cloud 0's
    frame): ``kp*`` [n, 3], FPFH-like non-negative ``desc*`` [n, 33],
    saliencies ``score*`` [n] above the loader's score gate."""
    n_shared = int(min(n0, n1) * overlap)
    shared = rng.uniform(-extent, extent, size=(n_shared, 3))
    only0 = rng.uniform(-extent, extent, size=(n0 - n_shared, 3))
    only1 = rng.uniform(-extent, extent, size=(n1 - n_shared, 3))
    base_desc = np.abs(rng.normal(size=(n_shared, 33)))
    kp0 = np.concatenate([shared, only0])
    desc0 = np.concatenate(
        [base_desc + desc_noise * rng.normal(size=base_desc.shape),
         np.abs(rng.normal(size=(n0 - n_shared, 33)))])
    R = _random_rotation(rng, np.deg2rad(10.0))
    t = rng.uniform(-3, 3, size=3)
    kp1 = (np.concatenate([shared, only1]) - t) @ R     # R^T (x - t) rowwise
    kp1 += jitter * rng.normal(size=kp1.shape)
    desc1 = np.concatenate(
        [base_desc + desc_noise * rng.normal(size=base_desc.shape),
         np.abs(rng.normal(size=(n1 - n_shared, 33)))])
    T_gt = np.eye(4)
    T_gt[:3, :3] = R
    T_gt[:3, 3] = t
    perm0 = rng.permutation(n0)
    perm1 = rng.permutation(n1)
    score0 = rng.uniform(10.5, 30.0, size=n0)
    score1 = rng.uniform(10.5, 30.0, size=n1)
    return {"kp0": kp0[perm0], "desc0": desc0[perm0], "score0": score0,
            "kp1": kp1[perm1], "desc1": desc1[perm1], "score1": score1,
            "T_gt": T_gt}


def moved_subset_pair(rng: np.random.Generator, n0: int, n1: int,
                      overlap: float = 0.7) -> Dict[str, np.ndarray]:
    """A pair whose cloud 1 is cloud 0's first ``overlap`` share turned
    about z, shifted and jittered, plus fresh points."""
    kp0 = rng.uniform(-30, 30, size=(n0, 3))
    desc0 = np.abs(rng.normal(size=(n0, 33)))
    shared = int(overlap * min(n0, n1))
    th = rng.uniform(-0.3, 0.3)
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1]])
    kp1 = np.concatenate([kp0[:shared] @ R.T + rng.normal(size=3),
                          rng.uniform(-30, 30, size=(n1 - shared, 3))])
    kp1[:shared] += rng.normal(scale=0.05, size=(shared, 3))
    desc1 = np.concatenate(
        [desc0[:shared] + 0.05 * rng.normal(size=(shared, 33)),
         np.abs(rng.normal(size=(n1 - shared, 33)))])
    return {"kp0": kp0, "desc0": desc0, "score0": rng.uniform(10, 30, n0),
            "kp1": kp1, "desc1": np.abs(desc1),
            "score1": rng.uniform(10, 30, n1)}


GENERATORS = {"synthetic": synthetic_pair, "moved_subset": moved_subset_pair}


def size_plan(traffic: Dict, seed: int) -> np.ndarray:
    """[pool, batch, 2] cloud sizes: one multiset for every seed (drawn
    from ``sizes_seed``), permuted by ``seed``."""
    lo, hi = traffic["sizes"]
    count = traffic["pool"] * traffic["batch"]
    base = np.random.default_rng(traffic["sizes_seed"]).integers(
        lo, hi + 1, size=(count, 2))
    order = rng_for(seed, 1).permutation(count)
    return base[order].reshape(traffic["pool"], traffic["batch"], 2)


def pool_pairs(traffic: Dict, seed: int) -> List[List[Dict]]:
    """The cell's pool: ``pool`` batches of ``batch`` pairs each."""
    make = GENERATORS[traffic["generator"]]
    rng = rng_for(seed, 2)
    kw = {"overlap": traffic["overlap"]}
    return [[make(rng, int(n0), int(n1), **kw) for n0, n1 in batch]
            for batch in size_plan(traffic, seed)]


def add_clouds(host: Dict[str, np.ndarray], rng: np.random.Generator,
               points: int) -> Dict[str, np.ndarray]:
    """``host`` (a stacked batch with ``keypoints*`` and ``mask*``) with raw
    clouds ``cloud0`` / ``cloud1`` [B, points, 8] float32 in each side's
    frame: every point a valid keypoint of its pair picked at random plus
    N(0, 1 m) on each axis, then five N(0, 1) channels."""
    out = dict(host)
    for side in "01":
        kp = host["keypoints" + side]
        counts = host["mask" + side].sum(axis=1)
        b = kp.shape[0]
        pick = (rng.random((b, points)) * counts[:, None]).astype(np.int64)
        xyz = (np.take_along_axis(kp, pick[..., None], axis=1)
               + rng.standard_normal((b, points, 3), dtype=np.float32))
        feats = rng.standard_normal((b, points, 5), dtype=np.float32)
        out["cloud" + side] = np.concatenate(
            [xyz.astype(np.float32), feats], axis=-1)
    return out


def stack_index(host: Dict, batch: int) -> Dict:
    """``idx0`` / ``idx1`` as the loader's batches carry them (the eval
    pipeline counts a batch's pairs by them)."""
    out = dict(host)
    out["idx0"] = np.arange(batch)
    out["idx1"] = np.arange(batch)
    return out


def cycle(items: Sequence):
    """``items`` over and over, in order."""
    while True:
        yield from items
