"""Temporal-span metric primitives (host-side numpy).

Numerically exact re-implementations of the primitives the reference
vendors from MMAction2 (``eval/mr_utils.py``).  These run on the host:
per-query work is tiny, so there is nothing to win by pushing it to the
GPU — the accelerator budget belongs to the model.

Parity notes (each verified by golden tests against the reference):

* :func:`compute_temporal_iou_batch_paired` keeps the reference's hull
  "union" (max(ends) - min(starts)); not a true union, but required
  bit-for-bit for metric parity (``eval/mr_utils.py:32-34``).
* :func:`compute_average_precision_detection` keeps the greedy
  GT-locking assignment order (``eval/mr_utils.py:128-159``).
"""

from __future__ import annotations

import json

import numpy as np


def load_jsonl(filename):
    """Read a JSON-lines file into a list of dicts (``eval/mr_utils.py:11-13``)."""
    with open(filename, "r") as f:
        return [json.loads(line) for line in f if line.strip()]


def compute_temporal_iou_batch_paired(
    pred_windows: np.ndarray, gt_windows: np.ndarray
) -> np.ndarray:
    """Pairwise temporal IoU of aligned (N, 2) window arrays -> (N,).

    Uses the hull span (max end - min start) as the denominator, matching
    the reference exactly (``eval/mr_utils.py:16-37``); zero-hull pairs
    yield 0.
    """
    inter = np.maximum(
        0,
        np.minimum(pred_windows[:, 1], gt_windows[:, 1])
        - np.maximum(pred_windows[:, 0], gt_windows[:, 0]),
    )
    hull = np.maximum(pred_windows[:, 1], gt_windows[:, 1]) - np.minimum(
        pred_windows[:, 0], gt_windows[:, 0]
    )
    return np.divide(inter, hull, out=np.zeros_like(inter), where=hull != 0)


def compute_temporal_iou_batch_cross(
    spans1: np.ndarray, spans2: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """All-pairs temporal IoU of (N, 2) x (M, 2) -> ((N, M) iou, (N, M) union).

    True-union variant (``eval/mr_utils.py:40-67``).  Division by a zero
    union is left to propagate exactly as in the reference (numpy warns,
    emits nan/inf) so downstream argmax behavior is unchanged.
    """
    areas1 = spans1[:, 1] - spans1[:, 0]
    areas2 = spans2[:, 1] - spans2[:, 0]

    left = np.maximum(spans1[:, None, 0], spans2[None, :, 0])
    right = np.minimum(spans1[:, None, 1], spans2[None, :, 1])

    inter = np.clip(right - left, 0, None)
    union = areas1[:, None] + areas2[None, :] - inter
    return inter / union, union


def interpolated_precision_recall(precision: np.ndarray, recall: np.ndarray) -> float:
    """VOC-2011 interpolated AP over a precision/recall sweep
    (``eval/mr_utils.py:70-86``)."""
    mprec = np.hstack([[0], precision, [0]])
    mrec = np.hstack([[0], recall, [1]])
    # Make precision monotonically non-increasing from the right.
    for i in range(len(mprec) - 2, -1, -1):
        mprec[i] = max(mprec[i], mprec[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mprec[idx]))


def compute_average_precision_detection(
    ground_truth: list[dict],
    prediction: list[dict],
    tiou_thresholds: np.ndarray = np.linspace(0.5, 0.95, 10),
) -> np.ndarray:
    """Detection AP across IoU thresholds with greedy GT locking.

    ``ground_truth``/``prediction`` are lists of dicts with keys
    ``video-id``, ``t-start``, ``t-end``.  Matches
    ``eval/mr_utils.py:89-171`` including the per-threshold GT lock and
    prediction-order dependence.  Returns an array of AP values, one per
    threshold.
    """
    num_thds = len(tiou_thresholds)
    num_gts = len(ground_truth)
    ap = np.zeros(num_thds)
    if len(prediction) == 0:
        return ap

    lock_gt = np.full((num_thds, num_gts), -1.0)
    tp = np.zeros((num_thds, len(prediction)))
    fp = np.zeros((num_thds, len(prediction)))

    gt_by_vid: dict = {}
    for i, gt in enumerate(ground_truth):
        gt["index"] = i
        gt_by_vid.setdefault(gt["video-id"], []).append(gt)

    for pred_idx, pred in enumerate(prediction):
        gts = gt_by_vid.get(pred["video-id"])
        if gts is None:
            fp[:, pred_idx] = 1
            continue

        pred_span = np.array([[pred["t-start"], pred["t-end"]]])
        gt_spans = np.array([[g["t-start"], g["t-end"]] for g in gts])
        tiou = compute_temporal_iou_batch_cross(pred_span, gt_spans)[0].reshape(-1)
        order = tiou.argsort()[::-1]

        for t_idx, thd in enumerate(tiou_thresholds):
            for j in order:
                if tiou[j] < thd:
                    fp[t_idx, pred_idx] = 1
                    break
                if lock_gt[t_idx, gts[j]["index"]] >= 0:
                    continue
                tp[t_idx, pred_idx] = 1
                lock_gt[t_idx, gts[j]["index"]] = pred_idx
                break
            if fp[t_idx, pred_idx] == 0 and tp[t_idx, pred_idx] == 0:
                fp[t_idx, pred_idx] = 1

    tp_cum = np.cumsum(tp, axis=1).astype(float)
    fp_cum = np.cumsum(fp, axis=1).astype(float)
    recall_cum = tp_cum / float(num_gts)
    precision_cum = tp_cum / (tp_cum + fp_cum)

    for t_idx in range(num_thds):
        ap[t_idx] = interpolated_precision_recall(precision_cum[t_idx], recall_cum[t_idx])
    return ap


def _binary_pr_curve(y_true: np.ndarray, y_score: np.ndarray):
    """Precision-recall sweep identical to sklearn's
    ``precision_recall_curve`` (which the reference calls at
    ``eval/mr_utils.py:207``) for binary {0,1} labels."""
    y_true = np.asarray(y_true, dtype=float)
    y_score = np.asarray(y_score, dtype=float)

    # Sort by score descending; stable sort matches sklearn's mergesort.
    order = np.argsort(-y_score, kind="stable")
    y_true = y_true[order]
    y_score = y_score[order]

    # Indices where the score changes: these are the distinct thresholds.
    distinct = np.where(np.diff(y_score))[0]
    threshold_idxs = np.r_[distinct, y_true.size - 1]

    tps = np.cumsum(y_true)[threshold_idxs]
    fps = 1 + threshold_idxs - tps

    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    if tps[-1] == 0:
        recall = np.ones_like(tps)
    else:
        recall = tps / tps[-1]

    # Trim entries beyond full recall, reverse, and append the (p=1, r=0)
    # endpoint — mirrors sklearn's output convention.
    sl = slice(None, None, -1)
    precision = np.hstack((precision[sl], 1))
    recall = np.hstack((recall[sl], 0))
    thresholds = y_score[threshold_idxs][sl]
    return precision, recall, thresholds


def get_ap(y_true, y_predict, interpolate: bool = True, point_11: bool = False):
    """Saliency AP on binary labels (``eval/mr_utils.py:174-221``).

    Supports interpolated and 11-point variants; degenerate label sets
    short-circuit exactly like the reference (all-0 -> 0, all-1 -> 1).
    """
    y_true = np.asarray(y_true)
    y_predict = np.asarray(y_predict)
    assert len(y_true) == len(y_predict), "prediction/ground-truth length mismatch"

    unique = set(np.unique(y_true).tolist())
    if len(unique) == 1:
        return 0 if y_true[0] == 0 else 1
    assert unique == {0, 1}, "ground truth can only contain elements {0,1}"

    precision, recall, _ = _binary_pr_curve(y_true, y_predict)
    recall = recall.astype(np.float32)

    if interpolate:
        for i in range(1, len(precision)):
            precision[i] = max(precision[i - 1], precision[i])

    if point_11:
        precision_11 = [
            precision[np.where(recall >= t)[0][-1]] for t in np.arange(0, 1.01, 0.1)
        ]
        return np.mean(precision_11)
    indices = np.where(np.diff(recall))
    return np.mean(precision[indices])
