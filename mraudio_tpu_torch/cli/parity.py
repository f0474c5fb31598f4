"""One-command real-weight parity runner (the JAX package's
``cli/parity.py``): convert → evaluate → score → diff.

The reference validates itself by running its checkpoints end to end
(reference ``models/xinstructblip.py:79,98,192`` bundles, ``:149``
Vicuna) and scoring the prediction JSONL
(``scripts/infer/X-InstructBLIP/qvh.sh:5-17``).  This CLI packages that
protocol into one command for a machine that holds the weights:

    python -m mraudio_tpu_torch.cli.parity --ckpt-dir /ckpts \\
        --annotation highlight_val.jsonl --video-folder /videos \\
        --reference-jsonl reference_preds.jsonl --output-dir parity_out

which (1) converts the six artifacts (key routing and quantization),
(2) runs ``run_inference`` to ``parity_out/predictions.jsonl``, (3)
scores ours and the reference's predictions with the same
``eval_submission`` against the same ground truth, and (4) diffs the
metric briefs and the per-qid spans into ``parity_out/report.json``
with a PASS / FAIL verdict (NO-REFERENCE without ``--reference-jsonl``).

``--ckpt-dir`` expects the conventional filenames (``eva_vit_g.pth``,
``BEATs_iter3_plus_AS2M.pt``, ``video_qformer.pth``,
``audio_qformer_improved.pth``, ``blip2_pretrained.pth`` and an LLM state
dict); every artifact has an override flag.  ``--fabricate`` writes
random-weight checkpoints in the real key layouts
(``models/fabricate.py``), so the whole protocol runs without the real
bytes.  ``--device`` defaults to ``cuda``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

from mraudio_tpu_torch.models.fabricate import FILENAMES

logger = logging.getLogger("mraudio_tpu_torch")

# conventional --ckpt-dir filenames (the names the reference downloads)
CONVENTIONAL = {role: (name,) for role, name in FILENAMES.items()}
CONVENTIONAL["llm"] += ("vicuna-7b-v1.1.pth", "vicuna-7b-v1.1")


def _resolve_artifacts(ckpt_dir: str, overrides: dict) -> dict:
    paths = {}
    for role, names in CONVENTIONAL.items():
        if overrides.get(role):
            paths[role] = overrides[role]
            continue
        for name in names:
            cand = os.path.join(ckpt_dir, name) if ckpt_dir else ""
            if cand and os.path.exists(cand):
                paths[role] = cand
                break
        else:
            paths[role] = ""
    return paths


def brief_diff(ours: dict, ref: dict, tolerance: float) -> dict:
    """Per-key abs diff of two eval briefs; a key only one side carries is
    a mismatch."""
    keys = sorted(set(ours) | set(ref))
    diffs, worst = {}, 0.0
    for k in keys:
        a, b = ours.get(k), ref.get(k)
        if a is None or b is None:
            diffs[k] = {"ours": a, "reference": b, "match": False}
            worst = float("inf")
            continue
        d = abs(float(a) - float(b))
        worst = max(worst, d)
        diffs[k] = {"ours": a, "reference": b, "abs_diff": round(d, 6), "match": d <= tolerance}
    return {"per_key": diffs, "max_abs_diff": worst, "pass": worst <= tolerance}


def span_diff(ours: list, ref: list, tolerance: float) -> dict:
    """Per-qid window comparison of two prediction JSONLs: identical
    windows within ``tolerance``, and the same qids."""
    import numpy as np

    by_qid = lambda rows: {r["qid"]: r for r in rows}
    o, r = by_qid(ours), by_qid(ref)
    common = sorted(set(o) & set(r), key=str)
    mismatched = []
    for qid in common:
        a = np.asarray(o[qid].get("pred_relevant_windows") or [], np.float64)
        b = np.asarray(r[qid].get("pred_relevant_windows") or [], np.float64)
        if a.shape != b.shape or (a.size and np.abs(a - b).max() > tolerance):
            mismatched.append({"qid": qid, "ours": a.tolist(), "reference": b.tolist()})
    return {
        "common_qids": len(common),
        "only_ours": len(set(o) - set(r)),
        "only_reference": len(set(r) - set(o)),
        "mismatched": len(mismatched),
        "examples": mismatched[:20],
        "pass": not mismatched and not (set(o) ^ set(r)),
    }


def run_parity(args) -> dict:
    from mraudio_tpu_torch.cli.convert import resolve_params, save_param_store
    from mraudio_tpu_torch.config import (DataConfig, RunConfig, full_model_config,
                                          tiny_data_config, tiny_model_config)
    from mraudio_tpu_torch.eval.mr_eval import eval_submission
    from mraudio_tpu_torch.eval.span_utils import load_jsonl
    from mraudio_tpu_torch.infer.evaluate import refuse_unported, run_inference
    from mraudio_tpu_torch.models.convert_weights import WEIGHT_FIELDS, load_pretrained_params
    from mraudio_tpu_torch.models.factory import build_model

    os.makedirs(args.output_dir, exist_ok=True)
    if args.model_size == "tiny":
        cfg = RunConfig(model=tiny_model_config(),
                        data=tiny_data_config(n_frms=args.n_frms or 4))
    else:
        cfg = RunConfig(model=full_model_config(), data=DataConfig.for_dataset(args.dataset))

    if args.fabricate:
        from mraudio_tpu_torch.models.fabricate import fabricate_checkpoint_dir

        ckpt_dir = args.ckpt_dir or os.path.join(args.output_dir, "fabricated")
        logger.info("fabricating %s-config checkpoints into %s", args.model_size, ckpt_dir)
        fabricate_checkpoint_dir(cfg.model, ckpt_dir, seed=args.seed)
        args.ckpt_dir = ckpt_dir

    art = _resolve_artifacts(args.ckpt_dir, {
        "vit": args.vit, "beats": args.audio_encoder, "video_qformer": args.video_qformer,
        "audio_qformer": args.audio_qformer, "blip2": args.blip2, "llm": args.model_path,
    })
    missing = [k for k, v in art.items() if not v]
    if missing:
        raise SystemExit(
            f"missing checkpoint artifacts: {missing} — place them in --ckpt-dir under "
            f"conventional names ({CONVENTIONAL}) or pass the per-artifact flags")

    data = cfg.data.replace(annotation_file=args.annotation,
                            video_folder=args.video_folder or cfg.data.video_folder)
    if args.video_source:
        data = data.replace(video_source=args.video_source)
    cfg = cfg.replace(data=data, tokenizer_path=args.tokenizer_path or cfg.tokenizer_path,
                      **{WEIGHT_FIELDS[role]: path for role, path in art.items()})
    refuse_unported(cfg)

    # --- 1. convert (all six artifacts, the whole key routing) ---
    model = build_model(cfg, args.device)
    store = os.path.join(args.output_dir, "params_store")
    if args.reuse_store and os.path.isfile(store):
        resolve_params(model, cfg, params_store=store)
        logger.info("reused converted param store %s", store)
    else:
        load_pretrained_params(model, cfg)
        if args.save_store:
            save_param_store(store, model, {"parity": True})
            logger.info("saved converted param store to %s", store)

    # --- 2. evaluate -> predictions.jsonl ---
    ours_path = os.path.join(args.output_dir, "predictions.jsonl")
    result = run_inference(cfg, model=model, output_file=ours_path,
                           batch_size=args.batch_size, num_workers=args.num_workers,
                           device=args.device)
    logger.info("wrote %d predictions (%.3f clips/sec)", len(result["records"]),
                result["clips_per_sec"])

    # --- 3. score both JSONLs with the same eval_submission ---
    gt = load_jsonl(args.annotation)
    ours_metrics = eval_submission(load_jsonl(ours_path), gt, verbose=False,
                                   match_number=False)
    report = {
        "artifacts": art,
        "predictions": ours_path,
        "clips_per_sec": result["clips_per_sec"],
        "ours_brief": dict(ours_metrics["brief"]),
        "tolerance": args.tolerance,
    }

    # --- 4. diff against the reference's predictions ---
    if args.reference_jsonl:
        ref_preds = load_jsonl(args.reference_jsonl)
        ref_metrics = eval_submission(ref_preds, gt, verbose=False, match_number=False)
        report["reference_brief"] = dict(ref_metrics["brief"])
        report["brief_diff"] = brief_diff(report["ours_brief"], report["reference_brief"],
                                          args.tolerance)
        report["span_diff"] = span_diff(load_jsonl(ours_path), ref_preds, args.tolerance)
        report["pass"] = bool(report["brief_diff"]["pass"] and report["span_diff"]["pass"])
    else:
        report["reference_brief"] = None
        report["pass"] = None
        logger.info("no --reference-jsonl: conversion+eval+scoring ran; "
                    "parity comparison skipped")

    out = os.path.join(args.output_dir, "report.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    verdict = {True: "PASS", False: "FAIL", None: "NO-REFERENCE"}[report["pass"]]
    print(f"parity: {verdict}  (report: {out})")
    if report["pass"] is not None:
        print(json.dumps({
            "max_brief_abs_diff": report["brief_diff"]["max_abs_diff"],
            "span_mismatches": report["span_diff"]["mismatched"],
            "common_qids": report["span_diff"]["common_qids"],
        }))
    return report


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="one-command reference parity runner (convert -> eval -> score -> diff)")
    parser.add_argument("--ckpt-dir", default="",
                        help="directory with conventionally-named artifacts")
    parser.add_argument("--annotation", required=True, help="GT annotation JSONL (QVH schema)")
    parser.add_argument("--video-folder", default="")
    parser.add_argument("--reference-jsonl", default="",
                        help="the reference implementation's prediction JSONL on the same "
                             "annotation file")
    parser.add_argument("--output-dir", default="parity_out")
    parser.add_argument("--model-size", default="full", choices=["full", "tiny"])
    parser.add_argument("--dataset", default="QVH")
    parser.add_argument("--video-source", default="",
                        choices=["", "native", "synthetic", "npy"])
    parser.add_argument("--batch-size", type=int, default=2)
    parser.add_argument("--num-workers", type=int, default=2)
    parser.add_argument("--n-frms", type=int, default=0)
    parser.add_argument("--tolerance", type=float, default=1e-4,
                        help="max abs diff for brief metrics and spans")
    parser.add_argument("--seed", type=int, default=0)
    # per-artifact overrides
    parser.add_argument("--model-path", default="", help="LLM weights")
    parser.add_argument("--audio-encoder", default="", help="BEATs ckpt")
    parser.add_argument("--vit", default="")
    parser.add_argument("--video-qformer", default="")
    parser.add_argument("--audio-qformer", default="")
    parser.add_argument("--blip2", default="")
    parser.add_argument("--tokenizer-path", default="",
                        help="refused, as RunConfig.tokenizer_path (ROADMAP.md C.3)")
    parser.add_argument("--fabricate", action="store_true",
                        help="generate random-weight checkpoints with the real key layouts "
                             "(pipeline rehearsal)")
    parser.add_argument("--save-store", action="store_true",
                        help="persist the converted params to <output-dir>/params_store")
    parser.add_argument("--reuse-store", action="store_true",
                        help="load a previously saved params_store instead of re-converting")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda; cpu runs the plain "
                             "versions of the kernels)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    report = run_parity(args)
    if report["pass"] is False:
        raise SystemExit(1)
    return report


if __name__ == "__main__":
    main()
