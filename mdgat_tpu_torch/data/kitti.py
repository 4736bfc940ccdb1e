"""KITTI odometry asset readers (numpy only).

A copy of ``mdgat_tpu/data/kitti.py``: that package's ``data/__init__``
pulls in JAX, so the port keeps its own.

File formats (reference ``load_data.py``):

* ``<txt_path>/%02d/groundtruths.txt`` — TSV with header
  ``idx1 idx2 t_1 t_2 t_3 q_1 q_2 q_3 q_4``; only the two frame indices are
  consumed (``load_data.py:9-29``).
* ``<train_path>/poses/%02d.txt`` — 12 floats/line = 3x4 ``T_w_cam0``
  (``load_data.py:85-91``).
* ``<train_path>/calib/sequences/%02d/calib.txt`` — keeps the *last*
  parsable ``key: 12-floats`` line, i.e. ``Tr:`` = ``T_cam0_velo``
  (``load_data.py:74-82``).
* keypoint ``.bin`` — float32 rows of 37:
  ``[x, y, z, usip_score, fpfh_descriptor(33)]`` (``load_data.py:127-137``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

KEYPOINT_ROW_FLOATS = 37
DESCRIPTOR_DIM = 33

# split definition (load_data.py:31-45)
SPLIT_SEQS = {
    "train": [0, 2, 3, 4, 5, 6, 7],
    "val": [9],
    "test": [10],
}


def load_kitti_gt_txt(txt_root: str, seq: int) -> List[Dict]:
    """Parse one sequence's pair list, skipping the header line."""
    pairs = []
    path = os.path.join(txt_root, "%02d" % seq, "groundtruths.txt")
    with open(path) as f:
        for i, line in enumerate(f):
            if i == 0:
                continue
            parts = line.split()
            if len(parts) < 2:
                continue
            pairs.append({"seq": seq, "anc_idx": int(parts[0]),
                          "pos_idx": int(parts[1])})
    return pairs


def make_dataset_kitti_distance(txt_path: str, mode: str):
    if mode not in SPLIT_SEQS:
        raise ValueError(f"Invalid mode: {mode}")
    seq_list = list(SPLIT_SEQS[mode])
    dataset: List[Dict] = []
    for seq in seq_list:
        dataset += load_kitti_gt_txt(txt_path, seq)
    return dataset, seq_list


def load_calib(path: str) -> np.ndarray:
    """Return 4x4 T_cam0_velo — last parsable 'key: 12 floats' line wins."""
    calib = None
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            _, value = line.split(":", 1)
            try:
                vals = np.array([float(x) for x in value.split()])
            except ValueError:
                continue
            if vals.size == 12:
                calib = vals.reshape(3, 4)
    if calib is None:
        raise ValueError(f"no calib line in {path}")
    return np.vstack([calib, [0.0, 0.0, 0.0, 1.0]])


def load_poses(path: str) -> np.ndarray:
    """[T, 4, 4] float64 world-from-cam0 poses."""
    rows = []
    with open(path) as f:
        for line in f:
            vals = np.fromstring(line, dtype=np.float64, sep=" ")
            if vals.size != 12:
                continue
            rows.append(np.vstack([vals.reshape(3, 4), [0, 0, 0, 1]]))
    return np.stack(rows)


def read_keypoint_bin(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(keypoints [N,3], scores [N], descriptors [N,33]) from a .bin file."""
    raw = np.fromfile(path, dtype=np.float32).reshape(-1, KEYPOINT_ROW_FLOATS)
    return raw[:, :3], raw[:, 3], raw[:, 4:]


def split_keypoint_rows(raw: np.ndarray):
    raw = raw.reshape(-1, KEYPOINT_ROW_FLOATS)
    return raw[:, :3], raw[:, 3], raw[:, 4:]
