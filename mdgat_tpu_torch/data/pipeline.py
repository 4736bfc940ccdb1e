"""Batches for training: host shaping and device preprocessing.

Port of the in-memory part of ``mdgat_tpu/data/pipeline.py`` (reference
``SparseDataset``, ``load_data.py:47-321``), in its two stages:

* **host** (:func:`collate_pairs`): fixed-size shaping of in-memory pairs
  (``make_synthetic_pair``'s dicts), world-frame keypoints in float64, batch
  stacking into numpy arrays with ``mask0`` / ``mask1``;
* **device** (:func:`prepare_batch`): descriptor L2 normalisation and
  pose-based ground-truth correspondences as batched tensor code.

Fixed-size policy, as in the JAX package: with ``max_keypoints`` a cloud is
truncated or duplicate-padded to exactly that many points (the reference's
train policy, ``load_data.py:191-211``: every slot holds a real keypoint,
masks all true); without it clouds are zero-padded to the batch's largest
128-bucket with validity masks. The KITTI readers, the native loader and
the prefetcher are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from mdgat_tpu_torch.ops.geometry import gt_correspondences

MODEL_KEYS = ("keypoints0", "keypoints1", "scores0", "scores1",
              "descriptors0", "descriptors1", "gt_matches0", "gt_matches1",
              "mask0", "mask1")


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def duplicate_pad(kp, score, desc, target: int):
    """Reference pad: repeatedly prepend the first (target - len) rows
    (``load_data.py:197-211``). No keypoints at all zero-fills (callers
    emit an all-false mask)."""
    if len(kp) == 0:
        return (np.zeros((target, 3), kp.dtype if hasattr(kp, "dtype")
                         else np.float32),
                np.zeros((target,), np.float32),
                np.zeros((target, 33), np.float32))
    while target > len(kp):
        take = target - len(kp)
        kp = np.vstack([kp[:take], kp])
        score = np.hstack([score[:take], score])
        desc = np.vstack([desc[:take], desc])
    return kp, score, desc


def _shape_cloud(kp, score, desc, max_keypoints: Optional[int], pad_to: int):
    """(kp, score, desc, n_valid) at the batch's fixed size."""
    if max_keypoints is not None:
        n_valid = max_keypoints if len(kp) > 0 else 0
        if max_keypoints < len(kp):
            kp, score, desc = (kp[:max_keypoints], score[:max_keypoints],
                               desc[:max_keypoints])
        else:
            kp, score, desc = duplicate_pad(kp, score, desc, max_keypoints)
        return kp, score, desc, n_valid
    n = len(kp)
    out_kp = np.zeros((pad_to, 3), kp.dtype)
    out_sc = np.zeros((pad_to,), score.dtype)
    out_de = np.zeros((pad_to, desc.shape[1]), desc.dtype)
    out_kp[:n], out_sc[:n], out_de[:n] = kp, score, desc
    return out_kp, out_sc, out_de, n


def collate_pairs(pairs: Sequence[Dict[str, np.ndarray]],
                  max_keypoints: Optional[int] = None,
                  dtype=np.float32, bucket: int = 128
                  ) -> Dict[str, np.ndarray]:
    """In-memory pairs (``kp0, desc0, score0, kp1, desc1, score1, T_gt``
    with T_gt mapping cloud 1 into cloud 0's frame) -> one stacked numpy
    batch: ``keypoints0/1, scores0/1, descriptors0/1, mask0/1,
    kpts0_world/kpts1_world, T_gt``. The common world frame is cloud 0's:
    cloud 1 is moved by T_gt in float64 on the host, then cast. Without
    ``max_keypoints`` each side is padded to a multiple of ``bucket``."""
    tgt0 = _round_up(max(max(len(p["kp0"]) for p in pairs), 1), bucket)
    tgt1 = _round_up(max(max(len(p["kp1"]) for p in pairs), 1), bucket)
    rows = []
    for p in pairs:
        kp0, sc0, de0, n0 = _shape_cloud(p["kp0"], p["score0"], p["desc0"],
                                         max_keypoints, tgt0)
        kp1, sc1, de1, n1 = _shape_cloud(p["kp1"], p["score1"], p["desc1"],
                                         max_keypoints, tgt1)
        T = np.asarray(p["T_gt"], np.float64)
        mask0 = np.arange(len(kp0)) < n0
        mask1 = np.arange(len(kp1)) < n1
        rows.append({
            "keypoints0": kp0.astype(dtype), "keypoints1": kp1.astype(dtype),
            "scores0": sc0.astype(dtype), "scores1": sc1.astype(dtype),
            "descriptors0": de0.astype(dtype),
            "descriptors1": de1.astype(dtype),
            "mask0": mask0, "mask1": mask1,
            "kpts0_world": kp0.astype(np.float64).astype(dtype),
            "kpts1_world": (kp1.astype(np.float64) @ T[:3, :3].T
                            + T[:3, 3]).astype(dtype),
            "T_gt": T,
        })
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def prepare_batch(batch: Dict[str, np.ndarray], threshold: float,
                  mutual_check: bool, device,
                  compute_dtype: torch.dtype = torch.float32,
                  gt_dtype: torch.dtype = torch.float32
                  ) -> Dict[str, torch.Tensor]:
    """Device preprocessing of a :func:`collate_pairs` batch
    (``prepare_batch_fn`` of the JAX package): descriptors L2-normalised
    with the norm floored at 1e-30 (``load_data.py:290-292``), ground-truth
    matches from the world-frame keypoints in ``gt_dtype`` (int32, -1 =
    unmatched), everything as tensors on ``device``."""
    dev = torch.device(device)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
         for k, v in batch.items() if k != "T_gt"}
    out = {}
    for side in ("0", "1"):
        de = t["descriptors" + side]
        if de.dtype in (torch.float16, torch.bfloat16):
            de = de.float()
        nrm = torch.linalg.vector_norm(de, dim=-1, keepdim=True)
        out["descriptors" + side] = (de / nrm.clamp_min(1e-30)).to(compute_dtype)
        out["keypoints" + side] = t["keypoints" + side].to(compute_dtype)
        out["scores" + side] = t["scores" + side].to(compute_dtype)
        out["mask" + side] = t["mask" + side]
    gt = gt_correspondences(t["kpts0_world"].to(gt_dtype),
                            t["kpts1_world"].to(gt_dtype), threshold,
                            mutual_check, t["mask0"], t["mask1"])
    out.update(gt_matches0=gt.matches0, gt_matches1=gt.matches1, rep=gt.rep)
    out["T_gt"] = batch["T_gt"]
    return out


def model_inputs(batch: Dict) -> Dict:
    """The tensors the model's forward reads."""
    return {k: batch[k] for k in MODEL_KEYS if k in batch}
