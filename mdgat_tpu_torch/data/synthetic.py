"""Synthetic matched pairs for tests, smoke runs and benchmarks.

A copy of the pair generator of ``mdgat_tpu/data/synthetic.py`` (numpy
only): the reference's keypoint features are a separate download, so the
port ships a generator of data in the same form. A pair is built from a
latent world cloud: two overlapping views under a known rigid motion, with
jitter and descriptor noise, so a matcher can learn on it and the
ground-truth generator finds real matches. The same ``rng`` state gives the
same pair as the JAX package's generator, and :func:`write_synthetic_kitti`
writes, for the same arguments, the same bytes as that package's writer (the
same ``default_rng`` calls in the same order).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from mdgat_tpu_torch.data.kitti import KEYPOINT_ROW_FLOATS


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


def pair_to_bin_rows(kp, score, desc) -> np.ndarray:
    rows = np.concatenate([kp, score[:, None], desc], axis=1)
    if rows.shape[1] != KEYPOINT_ROW_FLOATS:
        raise ValueError(f"keypoint rows of {rows.shape[1]} floats, not "
                         f"{KEYPOINT_ROW_FLOATS}")
    return rows.astype(np.float32)


def write_synthetic_kitti(root: str, seqs=(0, 9, 10), frames_per_seq: int = 6,
                          pairs_per_seq: int = 8, n_points: int = 300,
                          seed: int = 0, cloud_points: int = 0) -> str:
    """Materialize a KITTI-layout dataset directory under ``root``.

    Creates calib/poses/groundtruths/keypoint-bins so the real
    :class:`~mdgat_tpu_torch.data.pipeline.SparseDataset` reader runs
    unmodified on it. Frames are placed on a synthetic trajectory; keypoints are
    stored in each frame's sensor frame consistent with the poses, so the
    pose-based GT correspondence generation finds the planted matches.
    ``cloud_points`` also writes the raw clouds the learned-descriptor modes
    read (not consumed by the port yet; kept so that the random stream, and
    with it every other file, agrees with the JAX package's writer).
    """
    rng = np.random.default_rng(seed)
    kp_dir = os.path.join(root, "keypoints", "synthetic")
    for seq in seqs:
        s = "%02d" % seq
        os.makedirs(os.path.join(root, "calib", "sequences", s), exist_ok=True)
        os.makedirs(os.path.join(root, "poses"), exist_ok=True)
        os.makedirs(os.path.join(root, "preprocess-random-full", s),
                    exist_ok=True)
        os.makedirs(os.path.join(kp_dir, s), exist_ok=True)

        # calib: a nontrivial T_cam0_velo; P lines exercise last-line-wins
        Rc = _random_rotation(rng, 0.3)
        tc = rng.uniform(-0.5, 0.5, 3)
        with open(os.path.join(root, "calib", "sequences", s,
                               "calib.txt"), "w") as f:
            f.write("P0: " + " ".join(
                str(x) for x in np.eye(3, 4).ravel()) + "\n")
            Tr = np.concatenate([Rc, tc[:, None]], axis=1)
            f.write("Tr: " + " ".join(str(x) for x in Tr.ravel()) + "\n")
        T_cam0_velo = np.vstack([np.concatenate([Rc, tc[:, None]], 1),
                                 [0, 0, 0, 1]])

        # world cloud shared by all frames of the sequence
        world = rng.uniform(-40, 40, size=(n_points * 2, 3))
        world_desc = np.abs(rng.normal(size=(n_points * 2, 33)))

        poses = []
        frames = []
        for fi in range(frames_per_seq):
            R = _random_rotation(rng, np.deg2rad(8))
            t = np.array([4.0 * fi, 0.1 * fi, 0.0]) + rng.uniform(-1, 1, 3)
            pose = np.eye(4)
            pose[:3, :3] = R
            pose[:3, 3] = t
            poses.append(pose)
            # sample visible subset, expressed in the frame's velodyne frame
            sel = rng.choice(len(world), size=n_points, replace=False)
            pts_w = world[sel] + 0.03 * rng.normal(size=(n_points, 3))
            # world = pose @ T_cam0_velo @ x_velo  =>  x_velo = (pose Tcv)^-1 w
            M = np.linalg.inv(pose @ T_cam0_velo)
            pts_v = (pts_w @ M[:3, :3].T) + M[:3, 3]
            desc = world_desc[sel] + 0.05 * rng.normal(size=(n_points, 33))
            score = rng.uniform(10.5, 30.0, size=n_points)
            rows = pair_to_bin_rows(pts_v, score, np.abs(desc))
            rows.tofile(os.path.join(kp_dir, s, "%06d.bin" % fi))
            if cloud_points:
                # raw cloud for the learned-descriptor path: keypoints plus
                # filler points, 8 channels (xyz + 5), sensor frame
                cdir = os.path.join(root, "kitti_randomsample_16384_n8", s)
                os.makedirs(cdir, exist_ok=True)
                extra = rng.uniform(-40, 40,
                                    size=(cloud_points - n_points, 3))
                cxyz = np.concatenate([pts_v, extra])
                cfeat = rng.normal(size=(cloud_points, 5))
                np.concatenate([cxyz, cfeat], axis=1).astype(
                    np.float32).tofile(os.path.join(cdir, "%06d.bin" % fi))
            frames.append(fi)

        with open(os.path.join(root, "poses", "%02d.txt" % seq), "w") as f:
            for pose in poses:
                f.write(" ".join(str(x) for x in pose[:3].ravel()) + "\n")

        with open(os.path.join(root, "preprocess-random-full", s,
                               "groundtruths.txt"), "w") as f:
            f.write("idx1\tidx2\tt_1\tt_2\tt_3\tq_1\tq_2\tq_3\tq_4\n")
            for _ in range(pairs_per_seq):
                i, j = rng.choice(frames_per_seq, size=2, replace=False)
                f.write(f"{i}\t{j}\t0 0 0 1 0 0 0\n")
    return kp_dir


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
