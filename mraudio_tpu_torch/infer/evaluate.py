"""Batched inference driver: dataset → generate → span parse → JSONL.

Streams predictions for an annotation file into a QVH-submission JSONL
with records ``{qid, query, vid, pred_relevant_windows, raw_out}`` (and
``pred_saliency_scores`` on the 2 s clip grid with the saliency head),
the records the JAX package's ``infer/evaluate.py::run_inference``
writes for the same weights:

* ``cfg.data.num_chunks``/``chunk_idx`` shard the annotation list;
* batches are static-shape with a validity mask (padded rows are skipped
  at write time);
* clips/s (valid clips over the wall seconds of the whole pass) is the
  throughput metric, with per-stage seconds from :class:`StageTimes`:
  ``generate`` (``generate_submit``: encoders, prefill and decode) and
  ``parse_write`` (``generate_finalize``'s detokenization, span parsing
  and the records).

Each wait for the loader's next batch, with its copy to the device, is
a ``load`` profiler span: one per batch and one more for the end of the
stream.

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

import numpy as np
import torch

from mraudio_tpu_torch.config import RunConfig
from mraudio_tpu_torch.data.annotations import chunk_annotations, load_annotations
from mraudio_tpu_torch.data.dataset import BatchLoader, MRDataset
from mraudio_tpu_torch.parallel import comm, local_batch_size, mesh_for, shard_module_
from mraudio_tpu_torch.text.postprocess import moment_str_to_list, post_process
from mraudio_tpu_torch.utils.profiling import StageTimes, annotate, profile_to

logger = logging.getLogger("mraudio_tpu_torch")

_STAT_KEYS = ("prefix_len", "encode_s", "prefill_s", "prefill_segments", "decode_s",
              "decode_steps", "decode_tokens", "moe_decode_experts", "moe_prefill_imbalance")


def saliency_to_clip_grid(frame_times, scores, duration) -> list:
    """Per-frame saliency resampled onto the QVH 2 s clip grid (one score
    per clip, the clip centres)."""
    num_clips = max(int(duration / 2), 1)
    clip_centers = 2.0 * np.arange(num_clips) + 1.0
    return np.interp(clip_centers, np.asarray(frame_times, np.float64),
                     np.asarray(scores)).tolist()


def build_model(cfg: RunConfig, device="cuda"):
    """The backbone ``cfg.model_name`` names on ``device``: seeded random
    weights (``cfg.train.seed``) with every checkpoint the config names
    overlaid (``convert_weights.load_pretrained_params``), uncast."""
    from mraudio_tpu_torch.models import factory
    from mraudio_tpu_torch.models.convert_weights import load_pretrained_params

    return load_pretrained_params(factory.build_model(cfg, device), cfg)


def refuse_unported(cfg: RunConfig) -> None:
    """Raise ``NotImplementedError``, naming the ROADMAP.md item, for a
    config that sets a tokenizer path, which the JAX package reads
    nowhere."""
    if cfg.tokenizer_path:
        raise NotImplementedError(
            "RunConfig.tokenizer_path is not read: the JAX package builds its models with "
            "ByteTokenizer and reads the field nowhere, so the port refuses it rather than "
            "ignore it (ROADMAP.md C.3); load a tokenizer with "
            "text.tokenizer.load_llama_tokenizer and pass it to the model instead")


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
    ``batches`` holds each batch's ``generate_submit`` stats (with routed
    experts, the routing counters too, which the log line also gives).

    Without ``model``, builds one on ``device`` with :func:`build_model`
    (seeded random weights and the checkpoints ``cfg`` names).  A config
    that names a tokenizer path raises ``NotImplementedError``.
    Parameters are cast for inference in place; with
    ``cfg.quant_encoders`` the model's ``ENCODER_PARAM_KEYS`` subtrees are
    then stored int8 (``models/quant_tree.py``).
    ``batch_fallback``: on ``torch.cuda.OutOfMemoryError`` the driver
    frees the allocator's cache, halves the batch size and restarts the
    whole pass (records are written only after a pass completes).

    On a mesh (``cfg.mesh``, one process per device; ``parallel/``) the
    full model's parameters are sliced into this rank's shards after the
    casts; each data rank generates its ``batch_size / data`` rows of
    every batch and the model ranks of a data group the same rows; the
    records are gathered in annotation order on every rank and rank 0
    alone writes ``output_file``.  An out-of-memory error raises there
    (one rank cannot halve its batch alone)."""
    from mraudio_tpu_torch.models.casting import cast_params_for_inference

    refuse_unported(cfg)
    mesh = mesh_for(cfg.mesh)
    if mesh is not None:
        local_batch_size(batch_size, mesh)
        batch_fallback = False
    if model is None:
        model = build_model(cfg, device)
    cast_params_for_inference(model)
    if cfg.quant_encoders:
        from mraudio_tpu_torch.models.quant_tree import quantize_module_

        quantize_module_(model, keys=getattr(model, "ENCODER_PARAM_KEYS", ()))
    if mesh is not None:
        shard_module_(model, mesh)

    if annotations is None:
        annotations = load_annotations(cfg.data.annotation_file)
    annotations = chunk_annotations(annotations, cfg.data.num_chunks, cfg.data.chunk_idx)

    # Preflight: the static timestamp/duration token budgets must hold
    # for this dataset's value range (truncation would corrupt the
    # interleave); a backbone without them (VideoLLaMA) has none to check.
    if hasattr(model, "prepare_text") and annotations:
        from mraudio_tpu_torch.text.tokenizer import validate_time_budgets

        max_dur = int(max(a["duration"] for a in annotations)) + 1
        validate_time_budgets(model.llm_tokenizer, model.cfg, max_dur)

    dataset = MRDataset(cfg.data, annotations=annotations, split="eval")
    fmt = cfg.model.time_format
    # the model's own config: VideoLLaMA has no saliency head
    want_saliency = bool(getattr(model.cfg, "saliency_head", False))

    def emit(batch, outputs, saliency, records, first: int):
        """Append ``(annotation position, record)`` for each valid row;
        row 0 of ``batch`` is annotation ``first``."""
        for row, (qid, query, vid, raw_out, dur, valid) in enumerate(zip(
            batch.qid, batch.query, batch.vid, outputs, batch.duration, batch.valid,
        )):
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
            record = {
                "qid": qid,
                "query": query,
                "vid": vid,
                "pred_relevant_windows": windows,
                "raw_out": raw_out,
            }
            if saliency is not None:
                record["pred_saliency_scores"] = saliency_to_clip_grid(
                    batch.timestamps[row], saliency[row], dur)
            records.append((first + row, record))

    def attempt(bs):
        """One full pass at batch size ``bs``."""
        rows = None
        if mesh is not None:
            lb = local_batch_size(bs, mesh)
            rows = (mesh.data_index * lb, lb)
        loader = BatchLoader(dataset, bs, shuffle=False, num_threads=max(num_workers, 1),
                             rows=rows)
        times = StageTimes()
        records: list[dict] = []
        batches: list[dict] = []
        start = time.time()
        it = iter(loader)

        def load():
            """The loader's next batch and its device inputs, or
            ``(None, None)`` at the end, inside the ``load`` span."""
            with annotate("load"):
                batch = next(it, None)
                return batch, (model.device_inputs(batch) if batch is not None else None)

        current, dev = load()
        inflight = None  # (batch, its first annotation, pending)
        first = rows[0] if rows else 0
        while current is not None or inflight is not None:
            if current is not None:
                batch, batch_dev = current, dev
                current, dev = load()
                stats = {}
                with times.stage("generate", items=int(batch.valid.sum())):
                    pending = model.generate_submit(batch=batch, device_inputs=batch_dev,
                                                    stats=stats)
                batches.append({k: stats[k] for k in _STAT_KEYS if k in stats})
                submitted = (batch, first, pending)
                first += bs
            else:
                submitted = None
            if inflight is not None:
                pbatch, pfirst, pending = inflight
                with times.stage("parse_write"):
                    if want_saliency:
                        outputs, saliency = model.generate_finalize(pending, return_saliency=True)
                    else:
                        outputs, saliency = model.generate_finalize(pending), None
                    emit(pbatch, outputs, saliency, records, pfirst)
            inflight = submitted
        if mesh is not None:
            # one copy of each data rank's records, in annotation order
            records = sorted(comm.allgather_results(records if mesh.model_index == 0 else []),
                             key=lambda x: x[0])
        records = [r for _, r in records]
        return records, len(records), time.time() - start, times, batches

    main = mesh is None or mesh.rank == 0
    tracing = (profile_to(profile_dir, cuda=model.device.type == "cuda")
               if profile_dir and main else contextlib.nullcontext())
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
    # the expert layers' routing counters, per batch (routed experts only)
    routing = {k: [round(b[k], 4) for b in batches if k in b]
               for k in ("moe_decode_experts", "moe_prefill_imbalance")}
    routing = {k: v for k, v in routing.items() if v}
    logger.info(
        "inference: %d clips in %.2fs (%.3f clips/sec); stages: %s%s",
        n_clips, elapsed, clips_per_sec, times.summary(),
        f"; routing per batch: {routing}" if routing else "",
    )

    if output_file and main:
        os.makedirs(os.path.dirname(os.path.abspath(output_file)), exist_ok=True)
        with open(output_file, "w") as f:
            for record in records:
                f.write(json.dumps(record) + "\n")
    return {"records": records, "clips_per_sec": clips_per_sec, "batch_size": bs,
            "stages": times.summary(), "batches": batches}
