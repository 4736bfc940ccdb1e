"""Batches for training: host loading and shaping, device preprocessing.

Port of ``mdgat_tpu/data/pipeline.py`` (reference ``SparseDataset``,
``load_data.py:47-321``), in its two stages:

* **host**: :class:`SparseDataset` over a KITTI-layout directory (file IO,
  score filter, fixed-size shaping, pose chains and world-frame keypoints in
  float64, batch stacking with ``mask0`` / ``mask1``), and
  :func:`collate_pairs`, the same shaping for in-memory pairs
  (``make_synthetic_pair``'s dicts);
* **device** (:func:`prepare_batch`): descriptor L2 normalisation and
  pose-based ground-truth correspondences as batched tensor code.

The learned-descriptor modes (``pointnet``, ``pointnetmsg``) also read each
frame's raw cloud, 16384 x 8 float32 from
``<train_path>/kitti_randomsample_16384_n8/<seq>/<idx>.bin``
(``load_data.py:171-178``), as ``cloud0`` / ``cloud1``; they go to the
device as they are, not normalised.

Fixed-size policy, as in the JAX package: with ``max_keypoints`` a cloud is
truncated or duplicate-padded to exactly that many points (the reference's
train policy, ``load_data.py:191-211``: every slot holds a real keypoint,
masks all true); without it clouds are zero-padded to the batch's largest
128-bucket with validity masks. Of the JAX package's ``SparseDataset`` the
multi-host arguments (``rows=``, ``pair_range=``), the native threaded loader
and the reduced-precision descriptor shipping are not ported.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from mdgat_tpu_torch.core.config import POINTNET_DESCRIPTORS, Config
from mdgat_tpu_torch.data import kitti
from mdgat_tpu_torch.ops.geometry import gt_correspondences

MODEL_KEYS = ("keypoints0", "keypoints1", "scores0", "scores1",
              "descriptors0", "descriptors1", "gt_matches0", "gt_matches1",
              "mask0", "mask1")
# the raw clouds of the learned-descriptor modes, where a batch has them
CLOUD_KEYS = ("cloud0", "cloud1")


# what prepare_batch leaves on the host
HOST_KEYS = ("T_gt", "sequence", "idx0", "idx1")


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


class SparseDataset:
    """Host-side pair source over KITTI assets (real or synthetic layout):
    pair lists, calibration and poses per sequence, and with
    ``memory_is_enough`` every keypoint file of the split read once."""

    def __init__(self, cfg: Config, mode: str):
        self.cfg = cfg
        self.mode = mode
        # keypoint / descriptor arrays leave the host at the compute width;
        # pose chains and T_gt stay float64
        self.host_dtype = (np.float64 if cfg.compute_dtype == "float64"
                           else np.float32)
        self.pairs, self.seq_list = kitti.make_dataset_kitti_distance(
            cfg.txt_path, mode)
        self.calib: Dict[str, np.ndarray] = {}
        self.poses: Dict[str, np.ndarray] = {}
        self.kp_cache: Dict[str, List[np.ndarray]] = {}
        for seq in self.seq_list:
            s = "%02d" % seq
            self.calib[s] = kitti.load_calib(os.path.join(
                cfg.train_path, "calib/sequences", s, "calib.txt"))
            self.poses[s] = kitti.load_poses(os.path.join(
                cfg.train_path, "poses", "%02d.txt" % seq))
            if cfg.memory_is_enough:
                folder = os.path.join(cfg.keypoints_path, s)
                names = sorted(os.listdir(folder), key=lambda x: int(x[:-4]))
                self.kp_cache[s] = [
                    np.fromfile(os.path.join(folder, n), dtype=np.float32)
                    for n in names]

    def __len__(self):
        return len(self.pairs)

    def _frame_path(self, s: str, idx: int) -> str:
        return os.path.join(self.cfg.keypoints_path, s, "%06d.bin" % idx)

    def _load_frame(self, s: str, idx: int):
        if s in self.kp_cache:
            raw = self.kp_cache[s][idx]
        else:
            raw = np.fromfile(self._frame_path(s, idx), dtype=np.float32)
        return kitti.split_keypoint_rows(raw)

    def _shape_keypoints(self, kp, score, desc, pad_to: Optional[int] = None):
        """Apply the fixed-size policy; returns (kp, score, desc, n_valid)."""
        cfg = self.cfg
        if cfg.ensure_kpts_num:
            valid = score > cfg.score_min          # load_data.py:183
            return _shape_cloud(kp[valid], score[valid], desc[valid],
                                cfg.max_keypoints, 0)
        tgt = pad_to if pad_to is not None else _round_up(max(len(kp), 1), 128)
        return _shape_cloud(kp, score, desc, None, tgt)

    def get_pair(self, idx: int, pad_to: Optional[int] = None) -> Dict:
        rec = self.pairs[idx]
        s = "%02d" % rec["seq"]
        i0, i1 = rec["anc_idx"], rec["pos_idx"]
        cloud0 = self._shape_keypoints(*self._load_frame(s, i0), pad_to)
        cloud1 = self._shape_keypoints(*self._load_frame(s, i1), pad_to)
        return self._assemble_pair(s, i0, i1, *cloud0, *cloud1)

    def _load_cloud(self, s: str, idx: int) -> np.ndarray:
        """A frame's raw 16384 x 8 cloud (``load_data.py:171-178``)."""
        path = os.path.join(self.cfg.train_path, "kitti_randomsample_16384_n8",
                            s, "%06d.bin" % idx)
        return np.fromfile(path, dtype=np.float32).reshape(-1, 8)

    def _assemble_pair(self, s, i0, i1, kp0, sc0, de0, n0,
                       kp1, sc1, de1, n1) -> Dict:
        pose0 = self.poses[s][i0].astype(np.float64)
        pose1 = self.poses[s][i1].astype(np.float64)
        Tcv = self.calib[s].astype(np.float64)
        # T_gt maps kp1 -> kp0 frame (load_data.py:238)
        T_gt = np.linalg.inv(Tcv) @ np.linalg.inv(pose0) @ pose1 @ Tcv
        # world-frame transforms (load_data.py:241-245), in float64 on the
        # host: pose chains over km-scale coordinates need it
        M0 = pose0 @ Tcv
        M1 = pose1 @ Tcv
        hdt = self.host_dtype
        clouds = {}
        if self.cfg.descriptor in POINTNET_DESCRIPTORS:
            clouds = {"cloud0": self._load_cloud(s, i0).astype(hdt),
                      "cloud1": self._load_cloud(s, i1).astype(hdt)}
        return {
            **clouds,
            "kpts0_world": (kp0.astype(np.float64) @ M0[:3, :3].T
                            + M0[:3, 3]).astype(hdt),
            "kpts1_world": (kp1.astype(np.float64) @ M1[:3, :3].T
                            + M1[:3, 3]).astype(hdt),
            "keypoints0": kp0.astype(hdt), "keypoints1": kp1.astype(hdt),
            "scores0": sc0.astype(hdt), "scores1": sc1.astype(hdt),
            "descriptors0": de0.astype(hdt), "descriptors1": de1.astype(hdt),
            "mask0": np.arange(len(kp0)) < n0,
            "mask1": np.arange(len(kp1)) < n1,
            "T_gt": T_gt, "sequence": s, "idx0": i0, "idx1": i1,
        }

    def _batch_bucket(self, idxs) -> int:
        """Variable-N bucket of a batch from raw row counts alone (cached
        array lengths under ``memory_is_enough``, file sizes otherwise), so
        that each pair is loaded exactly once."""
        rows = []
        for i in idxs:
            r = self.pairs[int(i)]
            s = "%02d" % r["seq"]
            for idx in (r["anc_idx"], r["pos_idx"]):
                if s in self.kp_cache:
                    rows.append(len(self.kp_cache[s][idx])
                                // kitti.KEYPOINT_ROW_FLOATS)
                else:
                    rows.append(os.path.getsize(self._frame_path(s, idx))
                                // (kitti.KEYPOINT_ROW_FLOATS * 4))
        return _round_up(max(max(rows), 1), 128)

    def batches(self, batch_size: int, shuffle: bool = False, seed: int = 0,
                drop_last: bool = True) -> Iterator[Dict]:
        """Stacked numpy batches (the DataLoader equivalent): every array
        key stacked, ``sequence`` a list, ``idx0`` / ``idx1`` arrays."""
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        n_b = (len(order) // batch_size if drop_last
               else -(-len(order) // batch_size))
        for b in range(n_b):
            idxs = order[b * batch_size:(b + 1) * batch_size]
            tgt = (None if self.cfg.ensure_kpts_num
                   else self._batch_bucket(idxs))
            pairs = [self.get_pair(int(i), pad_to=tgt) for i in idxs]
            out = {}
            for k in pairs[0]:
                if k == "sequence":
                    out[k] = [p[k] for p in pairs]
                elif k in ("idx0", "idx1"):
                    out[k] = np.array([p[k] for p in pairs])
                else:
                    out[k] = np.stack([p[k] for p in pairs])
            yield out


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
    """Device preprocessing of a :func:`collate_pairs` or
    :meth:`SparseDataset.batches` batch (``prepare_batch_fn`` of the JAX
    package): descriptors L2-normalised
    with the norm floored at 1e-30 (``load_data.py:290-292``), ground-truth
    matches from the world-frame keypoints in ``gt_dtype`` (int32, -1 =
    unmatched), everything as tensors on ``device`` (to a CUDA device from
    pinned host memory, asynchronously). ``T_gt`` and the host-side
    ``sequence`` / ``idx0`` / ``idx1`` pass through as they are. Raw clouds
    (``cloud0`` / ``cloud1``, where the batch has them) are copied to
    ``device`` the same way and not normalised, as in the JAX package."""
    dev = torch.device(device)

    def upload(v):
        t = torch.from_numpy(np.ascontiguousarray(v))
        if dev.type == "cuda":      # from pinned memory, without a host wait
            return t.pin_memory().to(dev, non_blocking=True)
        return t.to(dev)

    t = {k: upload(v) for k, v in batch.items() if k not in HOST_KEYS}
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
    out.update({k: t[k] for k in CLOUD_KEYS if k in t})
    out.update({k: batch[k] for k in HOST_KEYS if k in batch})
    return out


def model_inputs(batch: Dict) -> Dict:
    """The tensors the model's forward reads."""
    return {k: batch[k] for k in MODEL_KEYS + CLOUD_KEYS if k in batch}
