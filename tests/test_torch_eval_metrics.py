"""The port's eval metrics (``mdgat_tpu_torch/eval/metrics.py``, its own
numpy copy) against ``mdgat_tpu/eval/metrics.py``: the cases of
``tests/test_metrics.py`` run through both packages' functions on the same
inputs. Both are numpy at float64, so every result is exactly equal:
counts, rates, pose numbers, statuses, accumulator summaries and state
vectors, meter merges, and the per-pair lines printed from ``update_batch``
and ``update_pair``. The SVD-failure fallbacks of ``_batched_pose_fit`` are
driven the same way in both."""

import math

import numpy as np
import pytest

import mdgat_tpu.eval.metrics as J
from test_metrics import (_make_eval_cases, _random_pair,
                          _random_padded_batch, _rigid)

import mdgat_tpu_torch.eval.metrics as P
from mdgat_tpu_torch import eval as port_eval

PAIR_LINE = ("{inlier} {inlier_ratio:.3f} {trans_error:.3f} "
             "{rot_error:.3f}")


def same(a, b, where="") -> None:
    """Exact equality of nested results: dicts, lists, tuples, arrays, and
    floats with NaN equal to NaN."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for k in a:
            same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b), where
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def test_exports_mirror_the_jax_package():
    import mdgat_tpu.eval as jeval
    names = [n for n in dir(jeval) if not n.startswith("_")
             and n not in ("metrics", "runner", "visualize")]
    for n in names:
        assert hasattr(port_eval, n), n


@pytest.mark.parametrize("protocol", ["test", "registration"])
@pytest.mark.parametrize("seed", range(8))
def test_matching_metrics(protocol, seed):
    rng = np.random.default_rng(seed + (100 if protocol != "test" else 0))
    matches, gt = _random_pair(rng)
    same(P.matching_metrics(matches, gt, protocol=protocol),
         J.matching_metrics(matches, gt, protocol=protocol))
    mask = rng.uniform(size=len(matches)) < 0.8
    same(P.matching_metrics(matches, gt, mask, protocol),
         J.matching_metrics(matches, gt, mask, protocol))


@pytest.mark.parametrize("case", ["all_gt_valid", "fp_gt_unmatched",
                                  "all_tp", "all_fn"])
def test_matching_metrics_edge_cases(case):
    if case == "all_gt_valid":
        gt = np.arange(10)
        matches = np.where(np.arange(10) % 2 == 0, gt, -1)
    elif case == "fp_gt_unmatched":
        matches = np.array([1, -1, -1, -1, -1, -1, -1, -1, -1, -1])
        gt = np.array([2, 3, 4, 5, 6, 7, 8, 9, 0, 1])
    elif case == "all_tp":
        gt = np.arange(6)
        matches = gt.copy()
    else:
        gt = np.arange(6)
        matches = np.full(6, -1)
    for protocol in ("test", "registration"):
        same(P.matching_metrics(matches, gt, protocol=protocol),
             J.matching_metrics(matches, gt, protocol=protocol))


@pytest.mark.parametrize("n_matches", [1, 2, 5, 40])
def test_pose_metrics_and_np_kabsch(n_matches):
    rng = np.random.default_rng(3 + n_matches)
    T_gt = _rigid(rng)
    mk0 = rng.normal(0, 5, (n_matches, 3))
    mk1 = (mk0 - T_gt[:3, 3]) @ T_gt[:3, :3] + rng.normal(0, 0.1, mk0.shape)
    same(P.np_kabsch(mk1, mk0), J.np_kabsch(mk1, mk0))
    for clamp in (False, True):
        same(P.pose_metrics(mk0, mk1, T_gt, clamp_arccos=clamp),
             J.pose_metrics(mk0, mk1, T_gt, clamp_arccos=clamp))


@pytest.mark.parametrize("calculate_pose", [True, False])
def test_accumulator_update_pair(calculate_pose):
    cases = _make_eval_cases(np.random.default_rng(7))
    acc_p, acc_j = P.TestEvalAccumulator(), J.TestEvalAccumulator()
    statuses = []
    for c in cases:
        got = acc_p.update_pair(*c, calculate_pose=calculate_pose)
        want = acc_j.update_pair(*c, calculate_pose=calculate_pose)
        same(got, want)
        statuses.append(got[0])
    assert {"banned", "too_few"} <= set(statuses)
    if calculate_pose:
        assert {"pose_fail", "ok"} <= set(statuses)
    same(acc_p.summary(), acc_j.summary())
    same(acc_p.state_vector(), acc_j.state_vector())
    same((acc_p.fail, acc_p.baned_data, acc_p.n_pairs),
         (acc_j.fail, acc_j.baned_data, acc_j.n_pairs))


def test_accumulator_banned_repeatability():
    n = 20
    kpts = np.zeros((n, 3))
    accs = [P.TestEvalAccumulator(), J.TestEvalAccumulator()]
    for acc in accs:
        acc.update_pair(np.full(n, -1), np.full(n, -1), kpts, kpts,
                        np.eye(4))
        acc.update_pair(np.full(n, -1), np.arange(n), kpts, kpts, np.eye(4))
    same(accs[0].summary(), accs[1].summary())
    assert accs[0].summary()["repeatability"] == 0.5


@pytest.mark.parametrize("calculate_pose", [True, False])
@pytest.mark.parametrize("seed", [41, 43])
def test_accumulator_update_batch(calculate_pose, seed):
    rng = np.random.default_rng(seed)
    batch = _random_padded_batch(rng)
    acc_p, acc_j = P.TestEvalAccumulator(), J.TestEvalAccumulator()
    got = acc_p.update_batch(*batch, calculate_pose=calculate_pose)
    want = acc_j.update_batch(*batch, calculate_pose=calculate_pose)
    same(got, want)
    same(acc_p.summary(), acc_j.summary())
    same(acc_p.state_vector(), acc_j.state_vector())


def test_printed_lines_of_update_batch_and_update_pair():
    """The per-pair print values of the port's batched path equal those of
    the JAX package's per-pair path (and its batched path) over many random
    batches."""
    rng = np.random.default_rng(43)
    n_lines = 0
    for _ in range(12):
        matches, gt, kpts0, kpts1, mask0, mask1, T_gt = \
            _random_padded_batch(rng, b=16, n=40)
        got = P.TestEvalAccumulator().update_batch(
            matches, gt, kpts0, kpts1, mask0, mask1, T_gt)
        want_b = J.TestEvalAccumulator().update_batch(
            matches, gt, kpts0, kpts1, mask0, mask1, T_gt)
        acc = J.TestEvalAccumulator()
        for i in range(16):
            s_r, _, pm_r = acc.update_pair(
                matches[i][mask0[i]], gt[i][mask0[i]],
                kpts0[i][mask0[i]], kpts1[i][mask1[i]], T_gt[i])
            s_g, _, pm_g = got[i]
            assert s_g == s_r == want_b[i][0]
            if pm_r is not None and not np.isnan(pm_r["rot_error"]):
                assert (PAIR_LINE.format(**pm_g) == PAIR_LINE.format(**pm_r)
                        == PAIR_LINE.format(**want_b[i][2]))
                n_lines += 1
    assert n_lines > 50


def test_accumulator_state_merge():
    cases = _make_eval_cases(np.random.default_rng(11))
    mid = len(cases) // 2
    merged = []
    for M in (P, J):
        halves = [M.TestEvalAccumulator(), M.TestEvalAccumulator()]
        for c in cases[:mid]:
            halves[0].update_pair(*c)
        for c in cases[mid:]:
            halves[1].update_pair(*c)
        merged.append(M.TestEvalAccumulator.from_state_vectors(
            [h.state_vector() for h in halves]))
    same(merged[0].summary(), merged[1].summary())
    same(merged[0].state_vector(), merged[1].state_vector())
    # the JAX package's vectors read back into the port's class, and back
    vec = merged[1].state_vector()
    same(P.TestEvalAccumulator.from_state_vectors([vec]).state_vector(), vec)


def test_average_meter_histories_and_records():
    rng = np.random.default_rng(3)
    a_vals = rng.normal(size=7).tolist()
    b_vals = rng.normal(size=4).tolist() + [float("nan")]
    vecs = {}
    for name, M in (("port", P), ("jax", J)):
        ma, mb = M.AverageMeter(record=True), M.AverageMeter(record=True)
        for v in a_vals:
            ma.update(v)
        for v in b_vals:
            mb.update(v)
        merged = M.AverageMeter.from_histories(
            [ma.history_vector(), mb.history_vector()])
        packed = [M.pack_meter_records([2, 5], {"a": ma, "b": mb}, ("a", "b")),
                  M.pack_meter_records([1, 3], {"a": M.AverageMeter(record=True),
                                                "b": mb}, ("a", "b"))]
        head, meters = M.merge_meter_records(packed, ("a", "b"))
        vecs[name] = (ma.history_vector(), merged.sum, merged.count,
                      merged.sq_sum, packed, head,
                      {k: (m.sum, m.count, m.avg) for k, m in meters.items()})
    same(vecs["port"], vecs["jax"])
    # a port meter's history replays in the JAX package's class
    m = P.AverageMeter(record=True)
    for v in a_vals:
        m.update(v)
    assert J.AverageMeter.from_histories([m.history_vector()]).sum == m.sum


def test_registration_summary():
    cases = _make_eval_cases(np.random.default_rng(11), n_pairs=16)
    out = []
    for M in (P, J):
        meters = {k: M.AverageMeter() for k in
                  ("rep", "rre", "rte", "inlier", "inlier_ratio", "recall",
                   "tp_rate", "fp_rate", "RR")}
        for matches, gt, kpts0, kpts1, T_gt in cases:
            mm = M.matching_metrics(matches, gt)
            if mm["banned"]:
                continue
            for k, src in (("rep", "repeatability"), ("fp_rate", "fp_rate"),
                           ("tp_rate", "tp_rate"), ("recall", "recall"),
                           ("inlier_ratio", "precision"), ("inlier", "tm")):
                meters[k].update(mm[src])
            valid = matches > -1
            pm = M.pose_metrics(kpts0[valid], kpts1[matches[valid]], T_gt)
            ok = pm["trans_error"] < 2 and pm["rot_error"] < np.pi / 36
            if pm["trans_error"] < 2:
                meters["rte"].update(pm["trans_error"])
            if pm["rot_error"] < np.pi / 36:
                meters["rre"].update(pm["rot_error"])
            meters["RR"].update(int(ok))
        out.append(M.registration_summary(meters))
    same(out[0], out[1])
    assert 0 < out[0]["RR"] < 1


@pytest.mark.parametrize("calculate_pose", [True, False])
def test_registration_batch_metrics(calculate_pose):
    rng = np.random.default_rng(47)
    matches, gt, kpts0, kpts1, mask0, mask1, T_gt = _random_padded_batch(rng)
    matches[1][:] = -1                       # an empty-match pair
    args = (matches, gt, kpts0, kpts1, mask0, mask1, T_gt)
    got = P.registration_batch_metrics(*args, calculate_pose=calculate_pose)
    same(got, J.registration_batch_metrics(*args,
                                           calculate_pose=calculate_pose))
    if calculate_pose:
        assert math.isnan(got[1][1])


def _fit_inputs(seed, short_row: bool, noise: float):
    rng = np.random.default_rng(seed)
    b, n = 2, 8
    kpts0 = rng.normal(0, 5, (b, n, 3))
    T_gt = np.stack([_rigid(rng) for _ in range(b)])
    kpts1 = np.stack([(kpts0[i] - T_gt[i, :3, 3]) @ T_gt[i, :3, :3]
                      for i in range(b)])
    kpts1 += rng.normal(0, noise, kpts1.shape)
    matches = np.tile(np.arange(n), (b, 1))
    valid = np.ones((b, n), bool)
    if short_row:
        valid[1, 3:] = False      # 3 matches: the per-pair redo path
    return matches, kpts0, kpts1, valid, T_gt


@pytest.mark.parametrize("short_row", [True, False])
def test_batched_pose_fit(short_row):
    args = _fit_inputs(11, short_row, 1e-3)
    same(P._batched_pose_fit(*args), J._batched_pose_fit(*args))
    fit_rows = np.array([True, False])
    same(P._batched_pose_fit(*args, fit_rows=fit_rows),
         J._batched_pose_fit(*args, fit_rows=fit_rows))


def test_batched_pose_fit_per_pair_svd_failure(monkeypatch):
    """The redo of a pair whose per-pair recompute diverges: a failed fit
    (identity T, 0 inliers, NaN errors) in both packages."""
    args = _fit_inputs(11, True, 0.0)

    def raising(*a, **k):
        raise np.linalg.LinAlgError("SVD did not converge")

    monkeypatch.setattr(P, "pose_metrics", raising)
    monkeypatch.setattr(J, "pose_metrics", raising)
    got = P._batched_pose_fit(*args)
    same(got, J._batched_pose_fit(*args))
    np.testing.assert_array_equal(got[0][1], np.eye(4))
    assert got[1][1] == 0 and np.isnan(got[2][1])


@pytest.mark.parametrize("fail_2d", [(2,), (2, 3)])
def test_batched_pose_fit_batched_svd_failure(monkeypatch, fail_2d):
    """``np.linalg.svd`` raising on the batched [B, 3, 3] call, then on the
    row-by-row retry of row 1 (and, second case, on the per-pair recompute
    too): both packages take the same fallbacks to the same numbers."""
    args = _fit_inputs(12, False, 1e-3)
    real_svd = np.linalg.svd
    results = []
    for M in (P, J):
        calls = {"n2d": 0}

        def stub(a, *sargs, **kwargs):
            if np.ndim(a) == 3:
                raise np.linalg.LinAlgError("SVD did not converge")
            calls["n2d"] += 1
            if calls["n2d"] in fail_2d:
                raise np.linalg.LinAlgError("SVD did not converge")
            return real_svd(a, *sargs, **kwargs)

        monkeypatch.setattr(np.linalg, "svd", stub)
        results.append(M._batched_pose_fit(*args))
        monkeypatch.setattr(np.linalg, "svd", real_svd)
    same(results[0], results[1])
    if len(fail_2d) == 2:
        np.testing.assert_array_equal(results[0][0][1], np.eye(4))
        assert np.isnan(results[0][2][1])
    else:
        assert np.isfinite(results[0][2]).all()
