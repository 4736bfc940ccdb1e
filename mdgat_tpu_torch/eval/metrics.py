"""Evaluation metric protocols of the reference test scripts, host numpy.

A copy of ``mdgat_tpu/eval/metrics.py`` (plain numpy, float64): the port
keeps its own, so that it imports nothing of the JAX package, and the two
give the same numbers bit for bit on the same inputs. Two protocols,
reproduced quantity for quantity:

* ``test.py`` (matching + pose eval, reference ``test.py:182-342``):
  per-pair precision/accuracy/recall/repeatability, fp/tp rates, SVD pose
  fit with inlier count, fail/ban bookkeeping.
* ``test_registration_metric.py`` (FCGF/D3Feat-style registration recall,
  reference ``test_registration_metric.py:184-286``): vectorized TP/FP/
  TN/FN, RTE/RRE with thresholded accumulation (RTE<2m, RRE<5 deg),
  RR, F1 of run averages.

All functions take host numpy arrays (one pair, or a padded batch with its
masks) and return plain dicts. The pose fit stays on the host: a 3x3 SVD a
pair is host work, and a device round trip would cost more than it.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class AverageMeter:
    """Running mean/variance accumulator (``utils/utils_test.py:6-25``).

    ``record=True`` additionally keeps the (val, n) update history so a
    multi-host run can merge by REPLAYING the per-process histories in
    process order — bit-identical to the single-process sequential sum
    (adding per-process partial sums would reassociate the f64 additions
    and can differ in the last ulp)."""

    def __init__(self, record: bool = False):
        self.record = record
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.sq_sum = 0.0
        self.count = 0
        self.history = []

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
        self.sq_sum += val ** 2 * n
        self.var = self.sq_sum / self.count - self.avg ** 2
        if self.record:
            self.history.append((float(val), float(n)))

    def history_vector(self) -> np.ndarray:
        """Flat f64 [val0, n0, val1, n1, ...] (requires ``record=True``
        to be non-trivially populated)."""
        return np.asarray(self.history, np.float64).reshape(-1)

    @classmethod
    def from_histories(cls, vecs) -> "AverageMeter":
        """Replay history vectors in the given order — the exact update
        sequence a single process would have applied."""
        m = cls()
        for vec in vecs:
            for val, n in np.asarray(vec, np.float64).reshape(-1, 2):
                m.update(float(val), int(n))
        return m


def pack_meter_records(head, meters: Dict[str, "AverageMeter"],
                       keys) -> np.ndarray:
    """Self-describing flat f64 encoding of ``head`` scalars plus the
    update histories of ``meters[k] for k in keys``:
    ``[len(head), head..., len(h_k0), h_k0..., len(h_k1), ...]``.
    The layout is consumed only by :func:`merge_meter_records`, so meter
    state growth cannot silently misalign a hand-rolled slice."""
    parts = [np.array([float(len(head))], np.float64),
             np.asarray(head, np.float64)]
    for k in keys:
        h = meters[k].history_vector()
        parts += [np.array([float(h.size)], np.float64), h]
    return np.concatenate(parts)


def merge_meter_records(vecs, keys):
    """Inverse of :func:`pack_meter_records` over per-process vectors (in
    process order): returns (summed head array, merged meters dict)."""
    heads = []
    hists = {k: [] for k in keys}
    for vec in vecs:
        vec = np.asarray(vec, np.float64)
        nh = int(vec[0])
        heads.append(vec[1:1 + nh])
        off = 1 + nh
        for k in keys:
            sz = int(vec[off])
            off += 1
            hists[k].append(vec[off:off + sz])
            off += sz
    head = np.sum(np.stack(heads), axis=0)
    meters = {k: AverageMeter.from_histories(hists[k]) for k in keys}
    return head, meters


def matching_metrics(matches: np.ndarray, gt_matches: np.ndarray,
                     valid_mask: Optional[np.ndarray] = None,
                     protocol: str = "registration") -> Dict:
    """Classification metrics for one pair.

    ``matches``/``gt_matches``: [N] int, -1 = unmatched. The reference's
    two eval scripts use *different* FP/TP-rate definitions; ``protocol``
    selects which one fills ``fm``/``fp_rate``/``tp_rate``:

    * ``"registration"`` (``test_registration_metric.py:238-248``):
      ``fp = valid & (matches != gt)``, ``fp_rate = FP/(FP+TN)``,
      ``tp_rate = TP/(TP+FN)``.
    * ``"test"`` (``test.py:277-291``): ``fp = valid & (gt == -1)``,
      ``fp_rate = FP / #(gt == -1)`` (nan when no gt-unmatched points, as
      the reference's unguarded numpy division), ``tp_rate =
      #(valid & gt > -1) / #(gt > -1)``, plus ``tp_rate2 =
      TP / #(gt > -1)``.

    Common quantities (precision/recall/accuracy/repeatability/banned)
    are identical between the scripts and always present.
    """
    if valid_mask is not None:
        matches = matches[valid_mask]
        gt_matches = gt_matches[valid_mask]
    valid = matches > -1
    valid_gt = gt_matches > -1
    tp = valid & (matches == gt_matches)
    fp = valid & (matches != gt_matches)
    tn = (~valid) & (~valid_gt)
    fn = (~valid) & valid_gt
    n = len(matches)
    n_tp, n_fp, n_tn, n_fn = map(int, (tp.sum(), fp.sum(), tn.sum(),
                                       fn.sum()))
    n_valid, n_gt = int(valid.sum()), int(valid_gt.sum())
    return _metrics_from_counts(
        n, n_valid, n_gt, n_tp, n_tn, protocol,
        n_fp=n_fp, n_fn=n_fn,
        n_fp_t=int((valid & ~valid_gt).sum()),
        n_vg=int((valid & valid_gt).sum()))


def _metrics_from_counts(n, n_valid, n_gt, n_tp, n_tn, protocol, *,
                         n_fp=0, n_fn=0, n_fp_t=0, n_vg=0) -> Dict:
    """The ONE copy of the metric formulas over per-pair integer counts —
    shared by :func:`matching_metrics` (counts from one pair's arrays) and
    the batched paths (counts as [B] integer reductions, sliced per row).
    ``n_fp``/``n_fn`` feed the "registration" rates, ``n_fp_t``/``n_vg``
    the "test" rates; callers pass whichever their protocol reads."""
    out = {
        "n": n,
        "n_valid": n_valid,
        "n_gt": n_gt,
        "repeatability": n_gt / n if n else 0.0,
        "precision": n_tp / n_valid if n_valid > 0 else 0.0,
        # test.py:283 gates recall on #valid > 0; an un-gated 0-GT pair is
        # 0/0 = nan in the reference's numpy division
        "recall": ((n_tp / n_gt if n_gt else float("nan"))
                   if n_valid > 0 else 0.0),
        "accuracy": (n_tp + n_tn) / n if n else 0.0,
        "matching_score": n_tp / n if n else 0.0,
        "tm": n_tp,
        "banned": n_gt < n * 0.1,        # test.py:247-251
    }
    if protocol == "test":
        # test.py:279-291 — FP counts valid predictions where GT says
        # "unmatched"; rates are normalized by GT-side counts.
        n_no_gt = n - n_gt
        out["fm"] = n_fp_t
        out["fp_rate"] = n_fp_t / n_no_gt if n_no_gt else float("nan")
        out["tp_rate"] = n_vg / n_gt if n_gt else float("nan")
        out["tp_rate2"] = n_tp / n_gt if n_gt else float("nan")
    else:
        # 0/0 -> nan, as the reference's unguarded numpy divisions
        # (test_registration_metric.py:247-248)
        out["fm"] = n_fp
        out["fp_rate"] = (n_fp / (n_fp + n_tn) if (n_fp + n_tn) > 0
                          else float("nan"))
        out["tp_rate"] = (n_tp / (n_tp + n_fn) if (n_tp + n_fn) > 0
                          else float("nan"))
    return out


def np_kabsch(P: np.ndarray, Q: np.ndarray) -> np.ndarray:
    """Host-side one-step SVD fit T: P -> Q (``solve_icp``,
    ``utils/utils_test.py:73-110``; no det-reflection fix, like the
    reference). Kept in numpy: a 3x3 SVD per pair is host-trivial and a
    device round trip would dominate eval latency."""
    up, uq = P.mean(axis=0), Q.mean(axis=0)
    U, _, Vh = np.linalg.svd((Q - uq).T @ (P - up))
    R = U @ Vh
    t = uq - R @ up
    T = np.zeros((4, 4))
    T[:3, :3] = R
    T[:3, 3] = t
    T[3, 3] = 1.0
    return T


def pose_metrics(mkpts0: np.ndarray, mkpts1: np.ndarray, T_gt: np.ndarray,
                 inlier_radius: float = 1.0,
                 clamp_arccos: bool = False) -> Dict:
    """SVD pose fit + errors (``calculate_error``,
    ``utils/utils_test.py:41-71``). mkpts are the matched keypoint
    coordinates; T = fit(mkpts1 -> mkpts0)."""
    T = np_kabsch(np.asarray(mkpts1, np.float64),
                  np.asarray(mkpts0, np.float64))
    moved = mkpts1 @ T[:3, :3].T + T[:3, 3]
    d = np.linalg.norm(moved - mkpts0, axis=-1)
    inlier = int((d < inlier_radius).sum())
    T_err = np.linalg.inv(T) @ np.asarray(T_gt)
    rte = float(np.linalg.norm(T_err[:3, 3]))
    f_theta = (T_err[0, 0] + T_err[1, 1] + T_err[2, 2] - 1.0) / 2
    if clamp_arccos:
        f_theta = min(max(f_theta, -1.0), 1.0)
    rre = float(np.arccos(f_theta))
    return {
        "T": T,
        "inlier": inlier,
        "inlier_ratio": inlier / len(mkpts0) if len(mkpts0) else 0.0,
        "trans_error": rte,
        "rot_error": rre,
    }


def _batched_pose_fit(matches, kpts0, kpts1, valid, T_gt, fit_rows=None):
    """One batched f64 Kabsch fit over padded [B, N] matches.

    ``valid`` [B, N] selects the matched rows; the fit equals the
    per-pair :func:`np_kabsch` on compacted arrays up to f64 summation
    reassociation (weighted einsum vs compacted ``np.mean``/matmul).
    ``fit_rows`` [B] (optional) marks the pairs whose fit the caller will
    actually consume — rows outside it (banned / too-few-match pairs the
    per-pair reference protocol never fits) are zeroed out of the batched
    SVD instead of wasting work or poisoning it with a degenerate matrix.
    Returns (T [B,4,4], inlier [B], rte [B], rre [B]); unfitted pairs get
    rte/rre = nan (the empty-match divergence documented in README — the
    reference would crash there)."""
    if fit_rows is not None:
        valid = valid & np.asarray(fit_rows, bool)[:, None]
    w = valid.astype(np.float64)
    n_valid = w.sum(1)
    nv = np.maximum(n_valid, 1.0)
    g1 = np.take_along_axis(
        kpts1, np.clip(matches, 0, kpts1.shape[1] - 1)[:, :, None],
        axis=1)                                     # [B, N, 3]
    up = (g1 * w[:, :, None]).sum(1) / nv[:, None]  # P centroid
    uq = (kpts0 * w[:, :, None]).sum(1) / nv[:, None]
    H = np.einsum("bn,bni,bnj->bij", w, kpts0 - uq[:, None],
                  g1 - up[:, None])                 # (Q-uq)(P-up)^T
    try:
        U, S, Vh = np.linalg.svd(H)
    except np.linalg.LinAlgError:
        # one non-converging 3x3 must not take down the whole batch:
        # redo row-by-row, routing the offender to the per-pair path.
        # Failed rows keep U = Vh = I (NOT zeros): R = U@Vh must stay
        # orthogonal so the batched inv(T) below cannot hit a singular
        # member before the redo loop replaces the row.
        U = np.tile(np.eye(3), (H.shape[0], 1, 1))
        S = np.zeros(H.shape[:2])
        Vh = np.tile(np.eye(3), (H.shape[0], 1, 1))
        svd_fail = np.zeros(H.shape[0], bool)
        for i in range(H.shape[0]):
            try:
                U[i], S[i], Vh[i] = np.linalg.svd(H[i])
            except np.linalg.LinAlgError:
                svd_fail[i] = True
    else:
        svd_fail = np.zeros(H.shape[0], bool)
    R = U @ Vh                                      # no det fix, like ref
    t = uq - np.einsum("bij,bj->bi", R, up)
    moved = np.einsum("bij,bnj->bni", R, g1) + t[:, None]
    d = np.linalg.norm(moved - kpts0, axis=-1)
    inlier = ((d < 1.0) & valid).sum(1)
    b = matches.shape[0]
    T = np.zeros((b, 4, 4))
    T[:, :3, :3] = R
    T[:, :3, 3] = t
    T[:, 3, 3] = 1.0
    T_err = np.linalg.inv(T) @ np.asarray(T_gt, np.float64)
    rte = np.linalg.norm(T_err[:, :3, 3], axis=-1)
    f_theta = (T_err[:, 0, 0] + T_err[:, 1, 1] + T_err[:, 2, 2] - 1.0) / 2
    with np.errstate(invalid="ignore"):
        rre = np.arccos(f_theta)                    # unclamped, like ref
    # <= 3 matches: the 3x3 covariance is rank-deficient, so the SVD null
    # direction is ambiguous and f64 reassociation noise can flip the
    # (reflection-unfixed) R between the batched and per-pair paths —
    # recompute those rare pairs exactly like the per-pair np_kabsch.
    # Same story for >= 4 exactly-coplanar matches (sigma3 ~ 0 relative
    # to sigma1: rank-deficient H, ill-conditioned SVD) and for a row
    # whose SVD failed outright. Generic >= 4 fits are full-rank and the
    # two paths agree to print precision (fuzz-tested).
    degenerate = S[:, 2] < 1e-9 * np.maximum(S[:, 0], 1e-300)
    redo = (n_valid > 0) & ((n_valid <= 3) | degenerate | svd_fail)
    for i in np.nonzero(redo)[0]:
        sel = valid[i]
        try:
            pm = pose_metrics(kpts0[i][sel], g1[i][sel],
                              np.asarray(T_gt[i]))
        except np.linalg.LinAlgError:
            # non-convergent even in the per-pair recompute (svd_fail
            # rows land here when both SVD calls diverge): record a
            # failed fit instead of aborting the whole eval batch — nan
            # errors gate every downstream `< threshold` comparison to
            # a registration fail, and the reference itself would crash
            # on this pair (same divergence class as the empty-match
            # case in the docstring).
            T[i] = np.eye(4)
            inlier[i] = 0
            rte[i] = np.nan
            rre[i] = np.nan
            continue
        T[i] = pm["T"]
        inlier[i] = pm["inlier"]
        rte[i] = pm["trans_error"]
        rre[i] = pm["rot_error"]
    empty = n_valid == 0
    rte = np.where(empty, np.nan, rte)
    rre = np.where(empty, np.nan, rre)
    return T, inlier, rte, rre


def registration_batch_metrics(matches, gt0, kpts0, kpts1, mask0, mask1,
                               T_gt=None, calculate_pose: bool = True):
    """Vectorized per-batch metrics for the registration-recall protocol
    (``test_registration_metric.py:238-256``): classification counts as
    integer [B]-reductions (protocol="registration" definitions) plus the
    shared batched pose fit. Returns [(mm, rte, rre)] in batch order;
    rte/rre are None when ``calculate_pose`` is off."""
    matches = np.asarray(matches)
    gt0 = np.asarray(gt0)
    mask0 = np.asarray(mask0, bool)
    mask1 = np.asarray(mask1, bool)
    kpts0 = np.asarray(kpts0, np.float64)
    kpts1 = np.asarray(kpts1, np.float64)
    b = matches.shape[0]

    valid = (matches > -1) & mask0
    valid_gt = (gt0 > -1) & mask0
    tp = valid & (matches == gt0)
    fp = valid & (matches != gt0)
    tn = (~valid) & (~valid_gt) & mask0
    fn = (~valid) & valid_gt
    n = mask0.sum(1)
    n_tp, n_fp, n_tn, n_fn = tp.sum(1), fp.sum(1), tn.sum(1), fn.sum(1)
    n_valid, n_gt = valid.sum(1), valid_gt.sum(1)

    rte = rre = [None] * b
    if calculate_pose:
        # the per-pair reference protocol fits every NON-banned pair
        # (test_registration_metric.py:230-256); skip the banned rows so
        # a degenerate pair the protocol never reads can't poison the
        # batched SVD (and the fit isn't wasted work)
        _, _, rte, rre = _batched_pose_fit(
            matches, kpts0, kpts1, valid, T_gt,
            fit_rows=n_gt >= n * 0.1)

    out = []
    for i in range(b):
        mm = _metrics_from_counts(
            int(n[i]), int(n_valid[i]), int(n_gt[i]), int(n_tp[i]),
            int(n_tn[i]), "registration",
            n_fp=int(n_fp[i]), n_fn=int(n_fn[i]))
        out.append((mm,
                    float(rte[i]) if calculate_pose else None,
                    float(rre[i]) if calculate_pose else None))
    return out


class TestEvalAccumulator:
    """The reference ``test.py`` per-pair accumulation protocol
    (``test.py:241-342``), factored out of the entry point so a unit test
    can drive it against a straight-line NumPy port of the reference.

    Reference-exact semantics:

    * repeatability is appended BEFORE the ban check (``test.py:241-251``)
      so banned pairs count toward the mean;
    * banned pairs increment both ``baned_data`` and ``fail``;
    * pairs with < 4 matches increment ``fail`` and append nothing else;
    * in pose mode the remaining metric arrays are appended only when the
      pose fit succeeds (RTE <= 2 m, RRE <= 5, non-nan); in non-pose mode
      they are never appended (so the aggregate line prints nan), exactly
      like the reference (``test.py:300-319``);
    * the final fail/ban rates divide by ``n_pairs - 1`` (the reference
      divides by the last enumerate index, ``test.py:339-342``).
    """

    KEYS = ("precision", "accuracy", "recall", "trans_error", "rot_error",
            "repeatability", "inlier", "inlier_ratio", "fp_rate",
            "tp_rate", "tp_rate2", "tm", "fm")

    def __init__(self):
        self.arrays: Dict[str, list] = {k: [] for k in self.KEYS}
        self.fail = 0
        self.baned_data = 0
        self.n_pairs = 0

    def _step(self, mm, pm_fn, calculate_pose: bool):
        """One pair's accumulation decision — the ONE copy of the
        reference sequence (repeatability-before-ban, ban/too-few/pose
        gates, array appends), shared by :meth:`update_pair` and
        :meth:`update_batch`. ``pm_fn`` lazily supplies the pose metrics
        so unfitted pairs never pay for (or read) a fit."""
        self.n_pairs += 1
        self.arrays["repeatability"].append(mm["repeatability"])
        if mm["banned"]:
            self.baned_data += 1
            self.fail += 1
            return "banned", mm, None
        if mm["n_valid"] < 4:                     # test.py:272-274
            self.fail += 1
            return "too_few", mm, None
        if not calculate_pose:
            return "ok_nopose", mm, None
        pm = pm_fn()
        if (pm["trans_error"] > 2 or pm["rot_error"] > 5
                or np.isnan(pm["trans_error"]) or np.isnan(pm["rot_error"])):
            self.fail += 1                        # test.py:296-298
            return "pose_fail", mm, pm
        a = self.arrays
        for k in ("trans_error", "rot_error", "inlier", "inlier_ratio"):
            a[k].append(pm[k])
        for k in ("precision", "accuracy", "recall", "fp_rate", "tp_rate",
                  "tp_rate2", "tm", "fm"):
            a[k].append(mm[k])
        return "ok", mm, pm

    def update_pair(self, matches: np.ndarray, gt0: np.ndarray,
                    kpts0: np.ndarray, kpts1: np.ndarray,
                    T_gt: Optional[np.ndarray] = None,
                    calculate_pose: bool = True):
        """Process one pair; returns (status, mm, pm) where status is one
        of 'banned' | 'too_few' | 'pose_fail' | 'ok' | 'ok_nopose'."""
        mm = matching_metrics(matches, gt0, protocol="test")

        def pm_fn():
            valid = matches > -1
            return pose_metrics(kpts0[valid], kpts1[matches[valid]], T_gt)

        return self._step(mm, pm_fn, calculate_pose)

    def update_batch(self, matches, gt0, kpts0, kpts1, mask0, mask1,
                     T_gt=None, calculate_pose: bool = True):
        """Vectorized :meth:`update_pair` over a PADDED batch.

        Inputs are the padded [B, N] / [B, N, 3] arrays straight from the
        eval pipeline (``mask0/1`` are the validity masks) — no per-pair
        boolean compaction on the host. The classification counts are
        integer reductions (bit-exact vs the per-pair path); the pose fits
        run as ONE batched f64 3x3 SVD (``np.linalg.svd`` on [B,3,3]),
        whose centroid/covariance summation order differs from the
        per-pair compacted-array path by at most f64 reassociation noise
        (asserted < 1e-9 relative and 3-decimal-print-identical in
        ``tests/test_metrics.py``).

        Returns the per-pair [(status, mm, pm)] list in batch order with
        the exact :meth:`update_pair` accumulation semantics.
        """
        matches = np.asarray(matches)
        gt0 = np.asarray(gt0)
        mask0 = np.asarray(mask0, bool)
        mask1 = np.asarray(mask1, bool)
        kpts0 = np.asarray(kpts0, np.float64)
        kpts1 = np.asarray(kpts1, np.float64)
        b, n_pad = matches.shape

        # ---- classification counts (integer, order-free => bit-exact) --
        valid = (matches > -1) & mask0
        valid_gt = (gt0 > -1) & mask0
        tp = valid & (matches == gt0)
        tn = (~valid) & (~valid_gt) & mask0
        n = mask0.sum(1)
        n_tp = tp.sum(1)
        n_tn = tn.sum(1)
        n_valid = valid.sum(1)
        n_gt = valid_gt.sum(1)
        n_fp_t = (valid & ~valid_gt).sum(1)
        n_vg = (valid & valid_gt).sum(1)

        mms = [_metrics_from_counts(
            int(n[i]), int(n_valid[i]), int(n_gt[i]), int(n_tp[i]),
            int(n_tn[i]), "test",
            n_fp_t=int(n_fp_t[i]), n_vg=int(n_vg[i])) for i in range(b)]

        # ---- batched pose fit, only over rows the protocol will read ---
        pms = [None] * b
        if calculate_pose:
            fit_rows = np.array(
                [not mm["banned"] and mm["n_valid"] >= 4 for mm in mms])
            T, inlier, rte, rre = _batched_pose_fit(
                matches, kpts0, kpts1, valid, T_gt, fit_rows=fit_rows)
            for i in range(b):
                pms[i] = {
                    "T": T[i],
                    "inlier": int(inlier[i]),
                    "inlier_ratio": (inlier[i] / n_valid[i]
                                     if n_valid[i] else 0.0),
                    "trans_error": float(rte[i]),
                    "rot_error": float(rre[i]),
                }

        # ---- sequential protocol (the shared update_pair step) ---------
        return [self._step(mms[i], lambda pm=pms[i]: pm, calculate_pose)
                for i in range(b)]

    def summary(self) -> Dict:
        mean = {k: (float(np.mean(v)) if v else float("nan"))
                for k, v in self.arrays.items()}
        denom = max(self.n_pairs - 1, 1)
        mean["fail_rate"] = self.fail / denom
        mean["baned_rate"] = self.baned_data / denom
        return mean

    # -- multi-host merging: each process accumulates its contiguous pair
    #    slice, then the per-process states concatenate (the summary means
    #    are order-free; fail/ban/n_pairs counters are additive, so the
    #    merged summary equals a single-process pass over all pairs) --

    def state_vector(self) -> np.ndarray:
        """Flat f64 encoding: [fail, baned, n_pairs, 13 array lengths,
        arrays concatenated in KEYS order] (all counts exact in f64)."""
        head = [float(self.fail), float(self.baned_data),
                float(self.n_pairs)]
        head += [float(len(self.arrays[k])) for k in self.KEYS]
        body = [np.asarray(self.arrays[k], np.float64) for k in self.KEYS]
        return np.concatenate([np.array(head, np.float64)] + body)

    @classmethod
    def from_state_vectors(cls, vecs) -> "TestEvalAccumulator":
        acc = cls()
        nk = len(cls.KEYS)
        for vec in vecs:
            vec = np.asarray(vec, np.float64)
            acc.fail += int(vec[0])
            acc.baned_data += int(vec[1])
            acc.n_pairs += int(vec[2])
            lens = vec[3:3 + nk].astype(np.int64)
            off = 3 + nk
            for k, ln in zip(cls.KEYS, lens):
                acc.arrays[k].extend(vec[off:off + ln].tolist())
                off += ln
        return acc


def registration_summary(meters: Dict[str, AverageMeter]) -> Dict:
    """Final line of ``test_registration_metric.py:282-286``: F1 is
    computed from the *run-averaged* precision and recall."""
    p = meters["inlier_ratio"].avg
    r = meters["recall"].avg
    f1 = 2 * p * r / (p + r) if (p + r) > 0 else 0.0
    return {
        "repeatability": meters["rep"].avg,
        "inlier": meters["inlier"].avg,
        "RR": meters["RR"].avg,
        "precision": p,
        "recall": r,
        "F1": f1,
        "fp_rate": meters["fp_rate"].avg,
        "tp_rate": meters["tp_rate"].avg,
        "RTE": meters["rte"].avg,
        "RRE": meters["rre"].avg,
    }
