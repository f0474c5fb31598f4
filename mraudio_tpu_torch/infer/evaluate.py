"""Batched inference driver: dataset → generate → span parse → JSONL.

Streams predictions for an annotation file into a QVH-submission JSONL
with records ``{qid, query, vid, pred_relevant_windows, raw_out}``, the
records the JAX package's ``infer/evaluate.py::run_inference`` writes
for the same weights:

* ``cfg.data.num_chunks``/``chunk_idx`` shard the annotation list;
* batches are static-shape with a validity mask (padded rows are skipped
  at write time);
* clips/s (valid clips over the wall seconds of the whole pass) is the
  throughput metric, with per-stage seconds from :class:`StageTimes`:
  ``generate`` (``generate_submit``: encoders, prefill and decode) and
  ``parse_write`` (``generate_finalize``'s detokenization, span parsing
  and the records).

The loop keeps the reference's two-deep structure (batch ``i+1`` is
loaded and submitted before batch ``i``'s strings are decoded and
written), but ``generate_submit`` blocks here: its decode loop reads one
flag from the device every step.  So only the loader threads overlap the
device; the parse-and-write of a batch and the device work of the next
do not.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time

import torch

from mraudio_tpu_torch.config import RunConfig
from mraudio_tpu_torch.data.annotations import chunk_annotations, load_annotations
from mraudio_tpu_torch.data.dataset import BatchLoader, MRDataset
from mraudio_tpu_torch.text.postprocess import moment_str_to_list, post_process
from mraudio_tpu_torch.utils.profiling import StageTimes, profile_to

logger = logging.getLogger("mraudio_tpu_torch")

_STAT_KEYS = ("prefix_len", "encode_s", "prefill_s", "prefill_segments", "decode_s",
              "decode_steps", "decode_tokens")
# RunConfig's paths to converted weights and the tokenizer: the port cannot
# load them, so a config that names one is refused, never run at random
_WEIGHT_FIELDS = ("llm_weights", "vit_weights", "beats_weights", "video_qformer_weights",
                  "audio_qformer_weights", "blip2_stage1_weights", "tokenizer_path")


def build_model(cfg: RunConfig, device="cuda"):
    """X-InstructBLIP with seeded random weights (``cfg.train.seed``) on
    ``device``.  Loading converted weights is not ported."""
    from mraudio_tpu_torch.models.convert_jax import init_random_
    from mraudio_tpu_torch.models.xinstructblip import XInstructBLIP

    key = cfg.model_name.lower().replace("-", "").replace("_", "").replace(" ", "")
    if key not in ("xinstructblip", "instructblip", "x"):
        raise NotImplementedError(f"model {cfg.model_name!r} is not ported yet "
                                  "(ROADMAP.md A.6: VideoLLaMA)")
    model = XInstructBLIP(cfg.model, audio_cfg=cfg.data.audio, device=device)
    return init_random_(model, seed=cfg.train.seed)


def refuse_unported(cfg: RunConfig) -> None:
    """Raise ``NotImplementedError``, naming the ROADMAP.md item, for a
    config that asks for what the port cannot do yet: converted weights
    or a tokenizer path, int8 encoders, a mesh, the saliency head."""
    named = [f for f in _WEIGHT_FIELDS if getattr(cfg, f)]
    if named:
        raise NotImplementedError(
            f"loading converted weights ({', '.join(named)}) is not ported yet "
            "(ROADMAP.md A.8: tooling); leave them empty for seeded random weights")
    if cfg.quant_encoders:
        raise NotImplementedError("RunConfig.quant_encoders is not ported yet "
                                  "(ROADMAP.md A.2: models/quant_tree.py)")
    if cfg.mesh.num_devices > 1:
        raise NotImplementedError("a mesh of more than one device is not ported yet "
                                  "(ROADMAP.md A.7: parallelism)")
    if cfg.model.saliency_head:
        raise NotImplementedError("the saliency head is not ported yet "
                                  "(ROADMAP.md A.5: training)")


def run_inference(
    cfg: RunConfig,
    model=None,
    annotations: list[dict] | None = None,
    output_file: str | None = None,
    batch_size: int = 2,
    num_workers: int = 2,
    profile_dir: str | None = None,
    batch_fallback: bool = True,
    device="cuda",
) -> dict:
    """Returns ``{'records', 'clips_per_sec', 'batch_size', 'stages',
    'batches'}``: ``stages`` is the :class:`StageTimes` summary and
    ``batches`` holds each batch's ``generate_submit`` stats.

    Without ``model``, builds one on ``device`` with seeded random
    weights.  A config that names converted weights or a tokenizer path
    raises ``NotImplementedError``.  Parameters are cast for inference in
    place.
    ``batch_fallback``: on ``torch.cuda.OutOfMemoryError`` the driver
    frees the allocator's cache, halves the batch size and restarts the
    whole pass (records are written only after a pass completes)."""
    from mraudio_tpu_torch.models.casting import cast_params_for_inference

    refuse_unported(cfg)
    if model is None:
        model = build_model(cfg, device)
    cast_params_for_inference(model)

    if annotations is None:
        annotations = load_annotations(cfg.data.annotation_file)
    annotations = chunk_annotations(annotations, cfg.data.num_chunks, cfg.data.chunk_idx)

    # Preflight: the static timestamp/duration token budgets must hold
    # for this dataset's value range (truncation would corrupt the
    # interleave).
    if annotations:
        from mraudio_tpu_torch.text.tokenizer import validate_time_budgets

        max_dur = int(max(a["duration"] for a in annotations)) + 1
        validate_time_budgets(model.llm_tokenizer, model.cfg, max_dur)

    dataset = MRDataset(cfg.data, annotations=annotations, split="eval")
    fmt = cfg.model.time_format

    def emit(batch, outputs, records):
        for qid, query, vid, raw_out, dur, valid in zip(
            batch.qid, batch.query, batch.vid, outputs, batch.duration, batch.valid,
        ):
            if not valid:
                continue
            windows = moment_str_to_list(post_process(raw_out))
            # relative time formats emit 0-100 / 0-1 values: back to seconds
            if fmt in ("relative_integers", "relative_floats"):
                div = 100.0 if fmt == "relative_integers" else 1.0
                windows = [
                    [round(w[0] / div * dur, 2), round(w[1] / div * dur, 2)]
                    if len(w) == 2 and -1 not in w
                    else w
                    for w in windows
                ]
            records.append({
                "qid": qid,
                "query": query,
                "vid": vid,
                "pred_relevant_windows": windows,
                "raw_out": raw_out,
            })

    def attempt(bs):
        """One full pass at batch size ``bs``."""
        loader = BatchLoader(dataset, bs, shuffle=False, num_threads=max(num_workers, 1))
        times = StageTimes()
        records: list[dict] = []
        batches: list[dict] = []
        start = time.time()
        it = iter(loader)
        current = next(it, None)
        dev = model.device_inputs(current) if current is not None else None
        inflight = None  # (batch, pending)
        while current is not None or inflight is not None:
            if current is not None:
                batch, batch_dev = current, dev
                current = next(it, None)
                dev = model.device_inputs(current) if current is not None else None
                stats = {}
                with times.stage("generate", items=int(batch.valid.sum())):
                    pending = model.generate_submit(batch=batch, device_inputs=batch_dev,
                                                    stats=stats)
                batches.append({k: stats[k] for k in _STAT_KEYS if k in stats})
                submitted = (batch, pending)
            else:
                submitted = None
            if inflight is not None:
                pbatch, pending = inflight
                with times.stage("parse_write"):
                    emit(pbatch, model.generate_finalize(pending), records)
            inflight = submitted
        return records, len(records), time.time() - start, times, batches

    tracing = (profile_to(profile_dir, cuda=model.device.type == "cuda") if profile_dir
               else contextlib.nullcontext())
    bs = batch_size
    with tracing:
        while True:
            try:
                records, n_clips, elapsed, times, batches = attempt(bs)
                break
            except torch.cuda.OutOfMemoryError:
                if not (batch_fallback and bs > 1):
                    raise
            # past the handler, the failed pass's frames and tensors are released
            if model.device.type == "cuda":
                torch.cuda.empty_cache()
            bs = max(bs // 2, 1)
            logger.warning(
                "device out of memory at batch_size=%d; retrying the run at "
                "batch_size=%d (records are written only after a pass completes)",
                bs * 2, bs,
            )
    clips_per_sec = n_clips / elapsed if elapsed > 0 else 0.0
    logger.info(
        "inference: %d clips in %.2fs (%.3f clips/sec); stages: %s",
        n_clips, elapsed, clips_per_sec, times.summary(),
    )

    if output_file:
        os.makedirs(os.path.dirname(os.path.abspath(output_file)), exist_ok=True)
        with open(output_file, "w") as f:
            for record in records:
                f.write(json.dumps(record) + "\n")
    return {"records": records, "clips_per_sec": clips_per_sec, "batch_size": bs,
            "stages": times.summary(), "batches": batches}
