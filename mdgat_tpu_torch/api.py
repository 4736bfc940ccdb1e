"""Inference API: load weights, match keypoint clouds, fit the rigid pose.

Port of ``mdgat_tpu/api.py::Matcher``. Pairs are padded to 128-keypoint
buckets with validity masks (padded results equal unpadded), descriptors
are L2-normalised as the reference data layer does
(``load_data.py:290-292``) on the batch's device after the upload, a batch
runs as one forward on ``device`` or over a grid of devices
(``data_parallel`` x ``seq_parallel``, one thread a device,
``parallel/smap.py::make_eval_runtime``), and ``register`` adds the
reference's one-step SVD pose fit (``utils/utils_test.py:73-110``).

    >>> m = Matcher("model.npz", device="cuda")          # doctest: +SKIP
    >>> out = m.match_batch(pairs)                       # doctest: +SKIP
    >>> grid = Matcher("model.npz", device="cuda",
    ...                data_parallel=2)                  # doctest: +SKIP
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from mdgat_tpu_torch.core.checkpoint import (load_npz, load_pth_state_dict,
                                             state_dict_from_numpy)
from mdgat_tpu_torch.cli import check_seq_layout
from mdgat_tpu_torch.core.config import (POINTNET_DESCRIPTORS, Config,
                                         test_defaults)
from mdgat_tpu_torch.eval.metrics import np_kabsch
from mdgat_tpu_torch.models.mdgat import MDGAT
from mdgat_tpu_torch.parallel.smap import make_eval_runtime, upload
from mdgat_tpu_torch.utils.profiling import span

_BUCKET = 128


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class Matcher:
    """MDGAT matcher for library use.

    Weights, one of: ``checkpoint`` (a native ``.npz`` of the JAX package
    or a reference ``.pth``); ``params=`` and ``bn_state=`` trees of numpy
    arrays; or ``seed=`` for a seeded random init.
    ``device`` (required) is where the model runs ("cpu", "cuda",
    "cuda:1", ...); a CUDA device that is not there raises. ``overrides`` are
    :class:`~mdgat_tpu_torch.core.config.Config` fields on top of the eval
    preset (``test_defaults()``), e.g. ``compute_dtype="bfloat16"``,
    ``use_kernels=False``, ``net="superglue"`` or ``descriptor="FPFH_only"``
    / ``"FPFH_gloabal"``. The Matcher takes keypoints and FPFH descriptors,
    no raw cloud, so the learned-descriptor modes (``pointnet``,
    ``pointnetmsg``) raise ``ValueError``: their pairs go through the eval
    CLIs' pipeline (``eval/runner.py``). ``exact_topk=True`` selects the
    exact top-k on the kernel routes (the default is the attention kernel's
    value bisection; a CPU Matcher is exact either way).

    Multi-device serving, as the JAX ``Matcher``: ``data_parallel=N`` and
    ``seq_parallel=M`` serve ``match_batch`` over an N x M grid of model
    replicas in this process, one thread and one device a replica (the
    batch's rows split over the N data replicas, each pair's keypoints over
    a row's M seq members, which gather keys from each other);
    ``shard_map=False`` keeps one forward on one device. ``devices`` names
    the N x M devices, data-major, and may repeat one; by default a CUDA
    ``device`` gives ``cuda:0`` ... ``cuda:N*M-1`` (``ValueError`` when
    fewer are visible) and ``"cpu"`` N x M copies of the CPU. A batch is
    padded to a multiple of N with copies of its last pair, trimmed from
    the results, so the results equal one device's. Refused with
    ``ValueError`` before any forward: an M that does not divide the 128 of
    the keypoint buckets, ``descriptor="FPFH_gloabal"`` with M > 1 (its
    encoder pools over the whole cloud), N < 1, ``devices`` of another
    length than N x M.
    """

    def __init__(self, checkpoint: Optional[str] = None, *, device,
                 devices: Optional[Sequence] = None, params=None,
                 bn_state=None, seed: Optional[int] = None, **overrides):
        self.cfg: Config = test_defaults().replace(**overrides)
        if self.cfg.descriptor in POINTNET_DESCRIPTORS:
            raise ValueError(
                f"Matcher(descriptor={self.cfg.descriptor!r}): the Matcher "
                "takes keypoints and FPFH descriptors, not the raw clouds "
                "this mode encodes; evaluate it with test_torch.py")
        check_seq_layout(self.cfg)
        self.devices = self._grid_devices(torch.device(device), devices)
        if any(d.type == "cuda" for d in self.devices):
            if not torch.cuda.is_available():
                raise RuntimeError("Matcher(device='cuda'): no CUDA device")
            # full-precision f32 products on the card (TF32 keeps ~3 digits)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.meta: Dict = {}
        state_dict = None
        if checkpoint is not None:
            if checkpoint.endswith(".pth"):
                state_dict = load_pth_state_dict(checkpoint)
            else:
                params, bn_state, self.meta = load_npz(checkpoint)
        if params is not None or bn_state is not None:
            if params is None or bn_state is None:
                raise ValueError("pass BOTH params and bn_state")
            state_dict = state_dict_from_numpy(params, bn_state, self.cfg)
        self.model = MDGAT(self.cfg)
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        elif seed is not None:
            self.model.reset_parameters(seed)
        else:
            raise ValueError("pass a checkpoint path, params and bn_state, "
                             "or a seed")
        self._step = make_eval_runtime(self.model, self.cfg, self.devices)
        self._calls = 0         # match_batch calls: the spans' identifier
        self.device = self.devices[0]
        self.model = self._step.replicas[0][0]   # on self.device

    def _grid_devices(self, device: torch.device, devices):
        """The N x M devices of the grid, data-major."""
        n = self.cfg.data_parallel * self.cfg.seq_parallel
        if devices is not None:
            return [torch.device(d) for d in devices]
        if n <= 1 or device.type != "cuda":
            return [device] * max(n, 1)
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if visible < n:
            raise ValueError(f"Matcher: a {self.cfg.data_parallel} x "
                             f"{self.cfg.seq_parallel} grid takes {n} CUDA "
                             f"devices and {visible} are visible; pass "
                             "devices=[...] to repeat one")
        return [torch.device("cuda", i) for i in range(n)]

    # ------------------------------------------------------------------
    def match(self, kp0, desc0, kp1, desc1, score0=None, score1=None,
              normalize: bool = True) -> Dict[str, np.ndarray]:
        """Match one pair: ``kp*`` [n, 3], ``desc*`` [n, 33] FPFH,
        ``score*`` [n] saliencies (a constant when None). Returns numpy
        ``matches0`` [n0] / ``matches1`` [n1] (-1 = unmatched) and
        ``matching_scores0/1``."""
        return self.match_batch(
            [dict(kp0=kp0, desc0=desc0, kp1=kp1, desc1=desc1,
                  score0=score0, score1=score1)], normalize)[0]

    def prepare_batch(self, pairs, normalize: bool = True):
        """(batch dict of tensors on ``device``, per-pair true sizes):
        each cloud zero-padded to the batch's largest 128-bucket, with
        masks, descriptors L2-normalised on ``device`` (``normalize``)."""
        batch, sizes = self._host_batch(pairs, normalize)
        return upload(batch, self.device, normalize), sizes

    def _host_batch(self, pairs, normalize: bool):
        """The batch of :meth:`prepare_batch` on the host, descriptors raw:
        every side's fields allocated once at the batch's bucket and each
        pair written into its rows, cast in that copy; a missing score is
        20.0. The upload applies ``normalize`` on the batch's device
        (``parallel/smap.py::upload``)."""
        dt = np.dtype(self.cfg.compute_dtype if self.cfg.compute_dtype
                      != "bfloat16" else "float32")
        b = len(pairs)
        sizes = [(len(p["kp0"]), len(p["kp1"])) for p in pairs]
        batch = {}
        for side, n in zip("01", np.array(sizes).T):
            t = max(_round_up(int(n.max()), _BUCKET), _BUCKET)
            kp = np.zeros((b, t, 3), dt)
            de = np.zeros((b, t, np.shape(pairs[0]["desc" + side])[1]), dt)
            sc = np.zeros((b, t), dt)
            for i, p in enumerate(pairs):
                kp[i, :n[i]] = p["kp" + side]
                de[i, :n[i]] = p["desc" + side]
                score = p.get("score" + side)
                sc[i, :n[i]] = 20.0 if score is None else score
            batch.update({
                "keypoints" + side: torch.from_numpy(kp),
                "descriptors" + side: torch.from_numpy(de),
                "scores" + side: torch.from_numpy(sc),
                "mask" + side: torch.from_numpy(np.arange(t) < n[:, None])})
        return batch, sizes

    def match_batch(self, pairs, normalize: bool = True):
        """Match many pairs in one forward (the serving path), one forward a
        grid cell under ``data_parallel`` / ``seq_parallel``. ``pairs``:
        dicts with ``kp0, desc0, kp1, desc1`` and optional ``score0,
        score1``. Returns one :meth:`match` dict per pair."""
        pairs = list(pairs)
        if not pairs:
            return []
        n_real = len(pairs)
        # the data replicas take equal blocks of rows: fill with copies of
        # the last pair, trimmed below
        pairs += [pairs[-1]] * (-n_real % self.cfg.data_parallel)
        self._calls += 1
        with span("mdgat.entry.match_batch", self._calls):
            with span("mdgat.data.host_batch"):
                batch, sizes = self._host_batch(pairs, normalize)
            out = self._step(batch, rows=n_real, normalize=normalize)
            with span("mdgat.data.readback"):
                ma0 = out["matches0"].cpu().numpy()
                ma1 = out["matches1"].cpu().numpy()
                msc0 = out["matching_scores0"].float().cpu().numpy()
                msc1 = out["matching_scores1"].float().cpu().numpy()
            with span("mdgat.data.unpack"):
                return [{
                    "matches0": ma0[b, :n0].copy(),
                    "matches1": ma1[b, :n1].copy(),
                    "matching_scores0": msc0[b, :n0].copy(),
                    "matching_scores1": msc1[b, :n1].copy(),
                } for b, (n0, n1) in enumerate(sizes[:n_real])]

    def register(self, kp0, desc0, kp1, desc1, score0=None, score1=None,
                 normalize: bool = True, min_matches: int = 4,
                 inlier_radius: float = 1.0) -> Dict:
        """Match + one-step SVD pose fit. Adds ``T`` (4x4, cloud 1 into
        cloud 0's frame; None under ``max(min_matches, 3)`` matches),
        ``n_matches`` and ``inliers``."""
        out = self.match(kp0, desc0, kp1, desc1, score0, score1,
                         normalize=normalize)
        return self._pose_fit(out, kp0, kp1, min_matches, inlier_radius)

    def register_batch(self, pairs, normalize: bool = True,
                       min_matches: int = 4, inlier_radius: float = 1.0):
        """:meth:`register` over many pairs, matched in one forward."""
        pairs = list(pairs)
        outs = self.match_batch(pairs, normalize=normalize)
        return [self._pose_fit(out, p["kp0"], p["kp1"], min_matches,
                               inlier_radius)
                for p, out in zip(pairs, outs)]

    @staticmethod
    def _pose_fit(out: Dict, kp0, kp1, min_matches: int,
                  inlier_radius: float) -> Dict:
        valid = out["matches0"] >= 0
        out["n_matches"] = int(valid.sum())
        if out["n_matches"] < max(min_matches, 3):  # SVD needs >= 3
            out["T"], out["inliers"] = None, 0
            return out
        mk0 = np.asarray(kp0, np.float64)[valid]
        mk1 = np.asarray(kp1, np.float64)[out["matches0"][valid]]
        T = np_kabsch(mk1, mk0)
        moved = mk1 @ T[:3, :3].T + T[:3, 3]
        out["T"] = T
        out["inliers"] = int(
            (np.linalg.norm(moved - mk0, axis=1) < inlier_radius).sum())
        return out
