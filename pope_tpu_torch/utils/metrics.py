"""Dataset-level metric aggregation (host-side numpy; a copy of
pope_tpu/utils/metrics.py, which the port does not import).

Reference parity: src/utils/metrics.py:135-164 (error_acc / error_auc),
:181-215 (aggregate_metrics with 1..30 degree thresholds), pose/utils.py:227-253
(regressor-side aggregate_metrics adding meanErr).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

ANGULAR_THRESHOLDS = list(range(1, 31))


def error_acc(kind, errors, thresholds=None):
    """Fraction of errors below each threshold + median.
    Key format mirrors the reference: '{kind}:ACC{t:2d}', '{kind}:medianErr'."""
    thresholds = thresholds or ANGULAR_THRESHOLDS
    errors = np.asarray(errors, np.float64)
    res = {f"{kind}:ACC{t:2d}": float(np.sum(errors < t) / errors.shape[0]) for t in thresholds}
    res[f"{kind}:medianErr"] = float(np.median(errors))
    return res


def error_auc(kind, errors, thresholds=None):
    """Area under the recall-vs-error curve at each threshold.
    (metrics.py:149-164; trapezoid rule on the sorted error CDF)."""
    thresholds = thresholds or ANGULAR_THRESHOLDS
    errors = [0] + sorted(float(e) for e in np.asarray(errors).ravel())
    recall = list(np.linspace(0, 1, len(errors)))
    aucs = {}
    for thr in thresholds:
        last_index = np.searchsorted(errors, thr)
        y = recall[:last_index] + [recall[last_index - 1]]
        x = errors[:last_index] + [thr]
        aucs[f"{kind}:auc@{thr:2d}"] = float(np.trapezoid(y, x) / thr)
    return aucs


def epidist_prec(errors, thresholds, ret_dict=False):
    """Matching precision at epipolar-distance thresholds: mean over pairs of
    the per-pair fraction of matches below thr (src/utils/metrics.py:167-178).

    errors: list of per-pair arrays of (squared) epipolar errors."""
    precs = []
    for thr in thresholds:
        per_pair = [
            float(np.mean(np.asarray(errs) < thr)) if len(np.asarray(errs)) > 0 else 0.0
            for errs in errors
        ]
        precs.append(float(np.mean(per_pair)) if per_pair else 0.0)
    if ret_dict:
        return {f"prec@{t:.0e}": p for t, p in zip(thresholds, precs)}
    return precs


def aggregate_metrics(metrics, epi_err_thr=5e-4):
    """Aggregate R/t angular errors (and, when per-pair 'epi_errs' are
    recorded, matching precision) over a dataset run.

    `metrics` carries 'R_errs', 't_errs', 'identifiers' (and optionally
    'epi_errs': one array per pair) lists, mirroring the reference driver
    dicts. Returns the same key set and ordering as
    src/utils/metrics.py:181-215: R aucs, R accs, t aucs, t accs, prec@thr.
    """
    # de-dup identifiers (kept for interface parity; reference computes but
    # doesn't apply unq_ids either, metrics.py:191-193)
    ids = metrics.get("identifiers", [])
    OrderedDict((iden, i) for i, iden in enumerate(ids))

    r_errs = np.asarray(metrics["R_errs"], np.float64)
    t_errs = np.asarray(metrics["t_errs"], np.float64)
    out = {}
    out.update(error_auc("R", r_errs))
    out.update(error_acc("R", r_errs))
    out.update(error_auc("t", t_errs))
    out.update(error_acc("t", t_errs))
    if metrics.get("epi_errs"):
        out.update(epidist_prec(metrics["epi_errs"], [epi_err_thr], ret_dict=True))
    return out


def aggregate_metrics_mean(metrics):
    """Regressor-eval flavor adding mean errors (pose/utils.py:227-253)."""
    out = aggregate_metrics(metrics)
    out["R:meanErr"] = float(np.mean(np.asarray(metrics["R_errs"], np.float64)))
    out["t:meanErr"] = float(np.mean(np.asarray(metrics["t_errs"], np.float64)))
    return out


def recall_object(boxA, boxB):
    """Box IoU on [x0, y0, x1, y1] int boxes (pope_model_api.py:56-69,
    including the reference's +1 pixel-area convention)."""
    boxA = [int(x) for x in boxA]
    boxB = [int(x) for x in boxB]
    xA = max(boxA[0], boxB[0])
    yA = max(boxA[1], boxB[1])
    xB = min(boxA[2], boxB[2])
    yB = min(boxA[3], boxB[3])
    inter = max(0, xB - xA + 1) * max(0, yB - yA + 1)
    areaA = (boxA[2] - boxA[0] + 1) * (boxA[3] - boxA[1] + 1)
    areaB = (boxB[2] - boxB[0] + 1) * (boxB[3] - boxB[1] + 1)
    return inter / float(areaA + areaB - inter)
