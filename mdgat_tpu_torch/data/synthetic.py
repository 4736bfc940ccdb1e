"""Synthetic matched pairs for tests, smoke runs and benchmarks.

A copy of the pair generator of ``mdgat_tpu/data/synthetic.py`` (numpy
only): the reference's keypoint features are a separate download, so the
port ships a generator of data in the same form. A pair is built from a
latent world cloud: two overlapping views under a known rigid motion, with
jitter and descriptor noise, so a matcher can learn on it and the
ground-truth generator finds real matches. The same ``rng`` state gives the
same pair as the JAX package's generator. Writing a KITTI-layout dataset
directory is not ported yet.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _random_rotation(rng, max_angle_rad: float) -> np.ndarray:
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    ang = rng.uniform(-max_angle_rad, max_angle_rad)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * (K @ K)


def make_synthetic_pair(rng: np.random.Generator, n_points: int = 300,
                        overlap: float = 0.7, jitter: float = 0.05,
                        desc_noise: float = 0.05,
                        extent: float = 30.0) -> Dict[str, np.ndarray]:
    """One matched pair with known relative pose T_gt (kp1 -> kp0 frame)."""
    n_shared = int(n_points * overlap)
    shared = rng.uniform(-extent, extent, size=(n_shared, 3))
    only0 = rng.uniform(-extent, extent, size=(n_points - n_shared, 3))
    only1 = rng.uniform(-extent, extent, size=(n_points - n_shared, 3))

    base_desc = rng.normal(size=(n_shared, 33))
    base_desc = np.abs(base_desc)  # FPFH histograms are non-negative

    kp0 = np.concatenate([shared, only0])
    desc0 = np.concatenate(
        [base_desc + desc_noise * rng.normal(size=base_desc.shape),
         np.abs(rng.normal(size=(n_points - n_shared, 33)))])

    R = _random_rotation(rng, np.deg2rad(10.0))
    t = rng.uniform(-3, 3, size=3)
    # view-1 points expressed in view-1 frame: x1 = R^-1 (x0 - t)
    kp1_world = np.concatenate([shared, only1])
    kp1 = (kp1_world - t) @ R  # == R.T @ (x - t) rowwise
    kp1 += jitter * rng.normal(size=kp1.shape)
    desc1 = np.concatenate(
        [base_desc + desc_noise * rng.normal(size=base_desc.shape),
         np.abs(rng.normal(size=(n_points - n_shared, 33)))])

    T_gt = np.eye(4)
    T_gt[:3, :3] = R
    T_gt[:3, 3] = t

    perm0 = rng.permutation(n_points)
    perm1 = rng.permutation(n_points)
    scores0 = rng.uniform(10.5, 30.0, size=n_points)  # pass the score>10 gate
    scores1 = rng.uniform(10.5, 30.0, size=n_points)
    return {
        "kp0": kp0[perm0], "desc0": desc0[perm0], "score0": scores0,
        "kp1": kp1[perm1], "desc1": desc1[perm1], "score1": scores1,
        "T_gt": T_gt,
    }


class SyntheticDataset:
    """In-memory pair source: ``len`` and integer indexing."""

    def __init__(self, n_pairs: int = 32, n_points: int = 300, seed: int = 0,
                 **pair_kwargs):
        self.rng = np.random.default_rng(seed)
        self.pairs = [make_synthetic_pair(self.rng, n_points, **pair_kwargs)
                      for _ in range(n_pairs)]

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx):
        return self.pairs[idx]
