"""Moment-retrieval + highlight-detection evaluation.

Produces the exact metric dictionary of the reference's
``eval/mr_eval.py`` (``eval_submission``, ``:328-414``): a ``brief``
dict with MR-mAP@[.5:.05:.95], MR-R1@thresholds, MR-R1-avg, MR-mIoU and
invalid-prediction counts, plus optional HL-Hit1/HL-mAP when saliency
scores are present.

Design difference vs. the reference: no ``multiprocessing.Pool`` — the
per-query AP work is tiny and the host cores belong to the input
pipeline, so scoring runs as a plain loop over vectorised numpy
(results are identical; the reference's pool at ``eval/mr_eval.py:77``
only reorders completion, not values).  The ``num_workers`` argument is
kept for CLI compatibility and ignored.
"""

from __future__ import annotations

import json
from collections import OrderedDict, defaultdict

import numpy as np

from mraudio_tpu_torch.eval.span_utils import (
    compute_average_precision_detection,
    compute_temporal_iou_batch_cross,
    compute_temporal_iou_batch_paired,
    get_ap,
    load_jsonl,
)


def compute_mr_ap(
    submission: list[dict],
    ground_truth: list[dict],
    iou_thds: np.ndarray = np.linspace(0.5, 0.95, 10),
    max_gt_windows: int | None = None,
    max_pred_windows: int | None = None,
    num_workers: int = 0,
    chunksize: int = 50,
) -> dict:
    """Mean AP over IoU thresholds, averaged over queries
    (``eval/mr_eval.py:21-94``).  Keys are stringified thresholds plus
    ``"average"``; values are percentages rounded to 2 decimals."""
    del num_workers, chunksize  # kept for signature compatibility
    iou_thds = [float(f"{e:.2f}") for e in iou_thds]

    pred_by_qid = defaultdict(list)
    gt_by_qid = defaultdict(list)
    for d in submission:
        windows = d["pred_relevant_windows"]
        if max_pred_windows is not None:
            windows = windows[:max_pred_windows]
        for w in windows:
            pred_by_qid[d["qid"]].append(
                {"video-id": d["qid"], "t-start": w[0], "t-end": w[1]}
            )
    for d in ground_truth:
        windows = d["relevant_windows"]
        if max_gt_windows is not None:
            windows = windows[:max_gt_windows]
        for w in windows:
            gt_by_qid[d["qid"]].append(
                {"video-id": d["qid"], "t-start": w[0], "t-end": w[1]}
            )

    # Iterate qids present in the submission — including qids with no GT
    # entry (empty list), matching the reference's defaultdict lookup.
    ap_rows = [
        compute_average_precision_detection(
            gt_by_qid[qid], pred_by_qid[qid], tiou_thresholds=iou_thds
        )
        for qid in pred_by_qid
    ]
    ap_array = np.array(ap_rows)  # (#queries, #thresholds)
    ap_thds = ap_array.mean(0)
    result = dict(zip([str(e) for e in iou_thds], ap_thds))
    result["average"] = np.mean(ap_thds)
    return {k: float(f"{100 * v:.2f}") for k, v in result.items()}


def compute_mr_r1(
    submission: list[dict],
    ground_truth: list[dict],
    iou_thds: np.ndarray = np.linspace(0.5, 0.95, 10),
):
    """Recall@1 at IoU thresholds, plus R1-avg / mIoU / invalid count
    (``eval/mr_eval.py:97-138``).

    For each query only the top predicted window counts; the GT window is
    the one with the highest cross IoU against that prediction.
    """
    iou_thds = [float(f"{e:.2f}") for e in iou_thds]
    pred_by_qid = {d["qid"]: d["pred_relevant_windows"][0][:2] for d in submission}

    gt_by_qid = {}
    for d in ground_truth:
        gt_windows = d["relevant_windows"]
        best = 0
        if len(gt_windows) > 0:
            ious = compute_temporal_iou_batch_cross(
                np.array([pred_by_qid[d["qid"]]]), np.array(gt_windows)
            )[0]
            best = np.argmax(ious)
        gt_by_qid[d["qid"]] = gt_windows[best]

    qids = list(pred_by_qid.keys())
    pred_windows = np.array([pred_by_qid[q] for q in qids]).astype(float)
    gt_windows = np.array([gt_by_qid[q] for q in qids]).astype(float)
    paired_iou = compute_temporal_iou_batch_paired(pred_windows, gt_windows)

    recall_at_one = {
        str(thd): float(f"{np.mean(paired_iou >= thd) * 100:.2f}") for thd in iou_thds
    }
    invalid_pred_num = int(sum(1 for p in pred_windows if -1 in p))
    r1_avg = np.mean(list(recall_at_one.values()))
    miou = np.mean(paired_iou)
    return recall_at_one, r1_avg, miou, invalid_pred_num


def eval_moment_retrieval(
    submission: list[dict], ground_truth: list[dict], verbose: bool = True
) -> dict:
    """Score the full set under the four legacy range names.

    The reference removed QVH's short/middle/long range filtering but kept
    the four-way loop producing identical numbers under each name
    (``eval/mr_eval.py:179-216``).  We compute once and alias — output is
    identical, at a quarter of the cost.
    """
    del verbose
    iou_thd2ap = compute_mr_ap(submission, ground_truth)
    recall_at_one, r1_avg, miou, invalid_pred_num = compute_mr_r1(
        submission, ground_truth
    )
    metrics = {
        "MR-mAP": iou_thd2ap,
        "MR-R1": recall_at_one,
        "MR-R1-avg": r1_avg,
        "MR-mIoU": miou,
        "MR-invalid_pred_num": invalid_pred_num,
    }
    # Four aliases of the same dict contents (deep-copied so callers can
    # mutate one range without surprising another).
    return {
        name: json.loads(json.dumps(metrics))
        for name in ("short", "middle", "long", "full")
    }


def mk_gt_scores(gt_data: dict, clip_length: int = 2) -> np.ndarray:
    """Expand per-clip saliency annotations to the full video
    (``eval/mr_eval.py:279-288``): (#clips, 3) scores in [0, 4]."""
    num_clips = int(gt_data["duration"] / clip_length)
    scores = np.zeros((num_clips, 3))
    relevant_ids = np.array(gt_data["relevant_clip_ids"])
    scores[relevant_ids] = np.array(gt_data["saliency_scores"])
    return scores


def compute_hl_hit1(qid2preds: dict, qid2gt_binary: dict) -> float:
    """Hit@1: does the top-scored clip fall on a positive clip for any
    annotator (``eval/mr_eval.py:219-233``)."""
    hit_scores = np.zeros((len(qid2preds), 3))
    for idx, (qid, pred) in enumerate(qid2preds.items()):
        top_clip = np.argmax(pred["pred_saliency_scores"])
        gt = qid2gt_binary[qid]
        if top_clip < len(gt):
            hit_scores[idx] = gt[top_clip]
    return float(f"{100 * np.mean(np.max(hit_scores, 1)):.2f}")


def compute_hl_ap(
    qid2preds: dict, qid2gt_binary: dict, num_workers: int = 0, chunksize: int = 50
) -> float:
    """Saliency mAP over (query, annotator) pairs (``eval/mr_eval.py:236-276``).
    Length mismatches between prediction and GT clip counts are repaired by
    truncation / zero-padding exactly as the reference does."""
    del num_workers, chunksize
    ap_scores = np.zeros((len(qid2preds), 3))
    for idx, (qid, pred) in enumerate(qid2preds.items()):
        y_predict_full = np.array(pred["pred_saliency_scores"], dtype=float)
        for w_idx in range(3):
            y_true = qid2gt_binary[qid][:, w_idx]
            y_predict = y_predict_full
            if len(y_true) < len(y_predict):
                y_predict = y_predict[: len(y_true)]
            elif len(y_true) > len(y_predict):
                padded = np.zeros(len(y_true))
                padded[: len(y_predict)] = y_predict
                y_predict = padded
            ap_scores[idx, w_idx] = get_ap(y_true, y_predict)
    return float(f"{100 * np.mean(ap_scores):.2f}")


def eval_highlight(
    submission: list[dict], ground_truth: list[dict], verbose: bool = True
) -> dict:
    """Highlight detection at Fair/Good/VeryGood saliency minimums
    (``eval/mr_eval.py:291-325``)."""
    del verbose
    qid2preds = {d["qid"]: d for d in submission}
    qid2gt_full = {d["qid"]: mk_gt_scores(d) for d in ground_truth}

    metrics = {}
    for min_score, name in zip((2, 3, 4), ("Fair", "Good", "VeryGood")):
        qid2gt_binary = {k: (v >= min_score).astype(float) for k, v in qid2gt_full.items()}
        metrics[f"HL-min-{name}"] = {
            "HL-mAP": compute_hl_ap(qid2preds, qid2gt_binary),
            "HL-Hit1": compute_hl_hit1(qid2preds, qid2gt_binary),
        }
    return metrics


def eval_submission(
    submission: list[dict],
    ground_truth: list[dict],
    verbose: bool = True,
    match_number: bool = True,
) -> OrderedDict:
    """Top-level scorer (``eval/mr_eval.py:328-414``).

    ``submission`` records carry ``qid`` plus ``pred_relevant_windows``
    and/or ``pred_saliency_scores``; ``ground_truth`` records carry
    ``relevant_windows`` (QVH format, schema in the reference docstring).
    Returns an OrderedDict with a sorted ``brief`` summary first, then the
    per-section metric dicts sorted by key.
    """
    pred_qids = set(e["qid"] for e in submission)
    gt_qids = set(e["qid"] for e in ground_truth)
    if match_number:
        assert pred_qids == gt_qids, (
            "qids in ground_truth and submission must match. "
            "use `match_number=False` if you wish to disable this check"
        )
    else:
        shared = pred_qids & gt_qids
        submission = [e for e in submission if e["qid"] in shared]
        ground_truth = [e for e in ground_truth if e["qid"] in shared]

    eval_metrics: dict = {}
    brief: OrderedDict = OrderedDict()

    if "pred_relevant_windows" in submission[0]:
        mr = eval_moment_retrieval(submission, ground_truth, verbose=verbose)
        eval_metrics.update(mr)
        mr_brief = {
            "MR-full-mAP": mr["full"]["MR-mAP"]["average"],
            "MR-full-mAP@0.5": mr["full"]["MR-mAP"]["0.5"],
            "MR-full-mAP@0.75": mr["full"]["MR-mAP"]["0.75"],
            "MR-short-mAP": mr["short"]["MR-mAP"]["average"],
            "MR-middle-mAP": mr["middle"]["MR-mAP"]["average"],
            "MR-long-mAP": mr["long"]["MR-mAP"]["average"],
            "MR-full-R1@0.5": mr["full"]["MR-R1"]["0.5"],
            "MR-full-R1@0.7": mr["full"]["MR-R1"]["0.7"],
            "MR-full-R1-avg": mr["full"]["MR-R1-avg"],
            "MR-full-mIoU": mr["full"]["MR-mIoU"],
            "MR-full-invalid_pred_num": mr["full"]["MR-invalid_pred_num"],
        }
        brief.update(sorted(mr_brief.items(), key=lambda x: x[0]))

    if "pred_saliency_scores" in submission[0]:
        hl = eval_highlight(submission, ground_truth, verbose=verbose)
        eval_metrics.update(hl)
        brief.update(
            (f"{k}-{sub_k.split('-')[1]}", v[sub_k]) for k, v in hl.items() for sub_k in v
        )

    final = OrderedDict()
    final["brief"] = brief
    final.update(sorted(eval_metrics.items(), key=lambda x: x[0]))
    return final


def eval_main(argv: list[str] | None = None) -> None:
    """CLI: score a submission JSONL against a GT JSONL
    (``eval/mr_eval.py:417-439``)."""
    import argparse

    parser = argparse.ArgumentParser(description="Moments and Highlights Evaluation")
    parser.add_argument("--submission_path", type=str, required=True)
    parser.add_argument("--gt_path", type=str, required=True)
    parser.add_argument("--save_path", type=str, required=True)
    parser.add_argument("--not_verbose", action="store_true")
    args = parser.parse_args(argv)

    submission = load_jsonl(args.submission_path)
    gt = load_jsonl(args.gt_path)
    results = eval_submission(submission, gt, verbose=not args.not_verbose)
    if not args.not_verbose:
        print(json.dumps(results, indent=4))
    with open(args.save_path, "w") as f:
        f.write(json.dumps(results, indent=4))


if __name__ == "__main__":
    eval_main()
