"""Offline evaluation through ``infer/evaluate.py::run_inference``, as the
evaluate CLI drives it: the model built at the configuration's sizes,
its weights seeded on the card, annotations from the cell's mix, whole
batches of synthetic QVHighlights clips through the loader, the encoders,
prefill, greedy decode and the parse into records.

Set-up builds and seeds the model, builds the kernels its routes launch,
and runs ``warmup_batches`` batches of other clips (allocator and handles
warm).  The window is one pass over the cell's ``window_batches`` whole
batches, so every run does the same work.  With ``--trace 1`` a further
pass of ``trace_batches`` batches runs under ``torch.profiler``.  Then
the program's state is freed and the reference scores a sample of the
window's clips, drawn from the seed: every served token's logit against
the reference's best at its position and, where the cell's limits name
``logit_rel_err``, the logits the program chose each token from (kept
by a hook on the lm_head during the window) against the reference's.
"""

from __future__ import annotations

import gc
import math
import os
import sys
import time

import numpy as np

from portbench import traffic, weights


def _build(config: dict, device, llm_changes: dict | None = None):
    """``(RunConfig, model)`` for the configuration (its decoder settings
    changed by ``llm_changes``: a control), its parameters allocated in
    their serving dtypes (not yet filled)."""
    from mraudio_tpu_torch.config import (AudioFrontendConfig, BeatsConfig, LlamaConfig,
                                          LoraConfig, RunConfig, ViTConfig)
    from mraudio_tpu_torch.models.casting import cast_params_for_inference

    llm_changes = llm_changes or {}
    run_cfg = RunConfig.from_dict(config["program"])
    if config["model"] == "X-InstructBLIP":
        from mraudio_tpu_torch.models import factory

        run_cfg = run_cfg.replace(model=run_cfg.model.replace(
            llm=run_cfg.model.llm.replace(**llm_changes)))
        model = factory.build_model(run_cfg, device)
    elif config["model"] == "VideoLLaMA":
        from mraudio_tpu_torch.models.videollama import VideoLLaMA, VideoLLaMAConfig

        v = dict(config["videollama"])
        nested = dict(vit=ViTConfig, beats=BeatsConfig, llm=LlamaConfig, lora=LoraConfig)
        v.update({k: cls.from_dict(v[k]) for k, cls in nested.items()})
        v["llm"] = v["llm"].replace(**llm_changes)
        v.update({k: tuple(v[k]) for k in ("image_mean", "image_std")})
        model = VideoLLaMA(VideoLLaMAConfig(**v), audio_cfg=AudioFrontendConfig.from_dict(
            config["program"]["data"]["audio"]), device=device)
    else:
        raise ValueError(f"no builder for model {config['model']!r}")
    return run_cfg, cast_params_for_inference(model)


def _model_dict(config: dict) -> dict:
    return config["videollama"] if config["model"] == "VideoLLaMA" else config["program"]["model"]


class _Capture:
    """Keeps each batch's generated ids as ``generate_finalize`` receives
    them (one small copy to the host per batch) and, with ``logits``, the
    lm_head's last-position output at every call for the rows that
    :meth:`watch` names: the logits each served token was chosen from,
    the prefill's first, then one per decode pass.  They are copied as
    they come into host buffers allocated before the pass, so the
    device holds none of them."""

    def __init__(self, model, logits: bool):
        self.batches, self.rows, self.logits, self.calls, self.submitted = [], {}, {}, {}, -1
        self.submit, self.finalize = model.generate_submit, model.generate_finalize
        model.generate_submit, model.generate_finalize = self.on_submit, self
        self.vocab = model.llm.cfg.padded_vocab_size if logits else 0
        if logits:
            model.llm.lm_head.register_forward_hook(self.on_logits)

    def watch(self, rows: dict, calls: int = 0) -> None:
        """Start a pass; ``rows`` maps a batch of it to the (device) index
        tensor of the rows whose logits are kept, at most ``calls`` times."""
        import torch

        self.rows, self.submitted = (rows if self.vocab else {}), -1
        self.calls = dict.fromkeys(self.rows, 0)
        self.logits = {b: torch.empty((calls, len(r), self.vocab), dtype=torch.float32,
                                      pin_memory=r.is_cuda) for b, r in self.rows.items()}

    def on_submit(self, *args, **kwargs):
        self.submitted += 1
        return self.submit(*args, **kwargs)

    def on_logits(self, module, args, out) -> None:
        b = self.submitted
        if b in self.rows:
            rows = out[:, -1].index_select(0, self.rows[b]).float()
            self.logits[b][self.calls[b]].copy_(rows, non_blocking=True)
            self.calls[b] += 1

    def __call__(self, pending, return_saliency: bool = False):
        tokens = pending[0] if isinstance(pending, tuple) else pending
        self.batches.append(tokens.cpu().numpy().copy())
        return self.finalize(pending, return_saliency=return_saliency)


def _log(**values) -> None:
    """A line of phase seconds and counts on standard error."""
    print("portbench " + " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                                  for k, v in values.items()), file=sys.stderr, flush=True)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device, reset: bool = False) -> int:
    import torch

    if device.type != "cuda":
        return 0
    peak = torch.cuda.max_memory_allocated(device)
    if reset:
        torch.cuda.reset_peak_memory_stats(device)
    return peak


def _pass(run_cfg, model, anns, batch: int, device, trace_path: str | None = None):
    """One ``run_inference`` pass; returns ``(result, wall seconds)``."""
    from mraudio_tpu_torch.infer.evaluate import run_inference

    _sync(device)
    t = time.perf_counter()
    if trace_path is None:
        res = run_inference(run_cfg, model=model, annotations=anns, batch_size=batch,
                            num_workers=2, batch_fallback=False, device=device)
    else:
        from torch.profiler import ProfilerActivity, profile, record_function

        from portbench.trace import WINDOW

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                               if device.type == "cuda" else [])
        with profile(activities=activities) as prof:
            with record_function(WINDOW):
                res = run_inference(run_cfg, model=model, annotations=anns, batch_size=batch,
                                    num_workers=2, batch_fallback=False, device=device)
                _sync(device)
        t_end = time.perf_counter()
        prof.export_chrome_trace(trace_path)
        return res, t_end - t
    _sync(device)
    return res, time.perf_counter() - t


def _batch_stats(res: dict) -> list:
    return [{k: b[k] for k in ("prefix_len", "encode_s", "prefill_s", "decode_s", "decode_steps")
             if k in b} for b in res["batches"]]


def setup(ctx) -> dict:
    """Build the model, seed its weights, build the kernels its routes
    launch, and warm it up on other clips; returns the state the window
    reads."""
    config, mix, device = ctx.config, ctx.mix, ctx.device
    batch = mix["clips_per_batch"]
    t = time.perf_counter()
    run_cfg, model = _build(config, device)
    spec = weights.spec_of(model)
    _sync(device)
    t_build = time.perf_counter()
    weights.fill_module_(model, ctx.seed)
    _sync(device)
    t_fill = time.perf_counter()
    llm = _model_dict(config)["llm"]
    if device.type == "cuda" and "pallas" in (llm["attention_impl"], llm["decode_gemv"]):
        from mraudio_tpu_torch.ops import build

        build.build_all()
    t_kernels = time.perf_counter()
    capture = _Capture(model, logits="logit_rel_err" in ctx.cell["limits"])
    warm = traffic.annotations(mix, ctx.seed, batch * ctx.cell["warmup_batches"], first=0)
    _, warm_s = _pass(run_cfg, model, warm, batch, device)
    _log(import_s=t - ctx.t0, build_s=t_build - t, fill_s=t_fill - t_build,
         kernels_s=t_kernels - t_fill, warm_s=warm_s)
    return {"run_cfg": run_cfg, "model": model, "spec": spec, "capture": capture}


def window(ctx, state: dict) -> dict:
    """The timed pass (and the traced one): what the program produced."""
    import torch

    from portbench import flops, trace
    from portbench.reference.common import byte_text

    config, mix, device = ctx.config, ctx.mix, ctx.device
    run_cfg, model, capture = state["run_cfg"], state["model"], state["capture"]
    batch = mix["clips_per_batch"]
    n_batches = ctx.cell["window_batches"]
    anns = traffic.annotations(mix, ctx.seed, batch * n_batches, first=10_000)
    rng = np.random.default_rng([int(ctx.seed) & (2 ** 64 - 1), 7])
    sample = sorted(rng.choice(len(anns), replace=False,
                               size=min(ctx.cell["reference_clips"], len(anns))).tolist())
    rows = {}
    for i in sample:
        rows.setdefault(i // batch, []).append(i % batch)
    capture.batches.clear()
    capture.watch({b: torch.tensor(r, device=device) for b, r in rows.items()},
                  calls=_model_dict(config)["max_new_tokens"] + 1)
    _sync(device)
    setup_s = time.perf_counter() - ctx.t0

    setup_peak = _peak(device, reset=True)
    res, wall = _pass(run_cfg, model, anns, batch, device)
    window_peak = _peak(device)
    # the kept logits per clip: (calls, vocab)
    logits = {b * batch + r: kept[:capture.calls[b], j]
              for b, kept in capture.logits.items() for j, r in enumerate(rows[b])}
    _log(setup_s=setup_s, window_s=wall, batches=n_batches,
         batch_s=str([round(b["encode_s"] + b.get("prefill_s", 0) + b["decode_s"], 3)
                      for b in res["batches"]]))
    tokens = np.concatenate(capture.batches)[:len(anns)]
    capture.watch({})

    traced = None
    if ctx.trace:
        t_anns = traffic.annotations(mix, ctx.seed, batch * ctx.cell["trace_batches"],
                                     first=20_000)
        os.makedirs(ctx.scratch, exist_ok=True)
        path = os.path.join(ctx.scratch, "trace.json")
        t_res, t_wall = _pass(run_cfg, model, t_anns, batch, device, trace_path=path)
        t = time.perf_counter()
        traced = trace.summarize(path)
        traced.update(batches=_batch_stats(t_res), clips=len(t_res["records"]), pass_s=t_wall)
        _log(traced_pass_s=t_wall, trace_read_s=time.perf_counter() - t)

    model_cfg, data = _model_dict(config), config["program"]["data"]
    stats = _batch_stats(res)
    work = sum(flops.BATCH_FLOPS[config["flops"]](model_cfg, data["audio"], data["n_frms"], batch,
                                                  b["prefix_len"], b["decode_steps"])
               for b in stats)
    by_qid = {r["qid"]: r for r in res["records"]}
    # the served text of every clip against its ids
    text_mismatch = sum(1 for i, a in enumerate(anns)
                        if a["qid"] in by_qid and by_qid[a["qid"]]["raw_out"]
                        != byte_text(tokens[i][:_served_len(tokens[i])]))
    return {
        "anns": anns, "tokens": tokens, "sample": sample, "logits": logits,
        "finished": [i for i, a in enumerate(anns) if a["qid"] in by_qid],
        "text_mismatch": text_mismatch,
        "end_to_end": {"clips_per_s": len(res["records"]) / wall, "setup_s": setup_s,
                       "peak_mem_gib": window_peak / 2 ** 30},
        "memory_peak_bytes": max(setup_peak, _peak(device)),
        "record": {"window": {"clips": len(res["records"]), "batches": n_batches,
                              "seconds": wall, "batch_stats": stats,
                              "parse_write_s": res["stages"].get("parse_write", {})
                              .get("seconds", 0.0),
                              "flops": work, "clips_per_batch": batch},
                   "trace": traced},
    }


def score(ctx, spec: list, out: dict) -> dict:
    """The reference over the sample of the window's clips that finished:
    per served token, the gap by which its reference logit lies below the
    reference's best at its position (per clip the widest, and the mean
    over every served token of the sample); and, where the window kept
    them, the program's logits at those positions against the
    reference's: the norm of their difference over the reference's norm,
    both centred per position (a softmax reads logits up to a shift),
    over the whole sample."""
    import torch

    from portbench.reference.common import Weights, strict_f32

    device, config = ctx.device, ctx.config
    model_cfg, data = _model_dict(config), config["program"]["data"]
    anns, tokens = out["anns"], out["tokens"]
    finished = set(out["finished"])
    sample = [i for i in out["sample"] if i in finished]
    ref = ctx.reference_module()
    gaps, served_tokens, gap_sum, err2, norm2 = [], 0, 0.0, 0.0, 0.0
    t = time.perf_counter()
    with strict_f32(), torch.no_grad():
        w = Weights(weights.make(spec, ctx.seed, device))
        for i in sample:
            clip = traffic.clip_inputs(anns[i], data)
            clip["frames"] = torch.from_numpy(clip["frames"]).to(device)
            clip["wave"] = torch.from_numpy(clip["wave"]).to(device)
            served = tokens[i][:_served_len(tokens[i])].tolist()
            logits = ref.served_logits(w, model_cfg, data["audio"], clip, served)
            idx = torch.tensor(served, device=device)
            gap = logits.max(-1).values - logits.gather(1, idx[:, None])[:, 0]
            gaps.append(float(gap.max()))
            gap_sum += float(gap.sum())
            served_tokens += len(served)
            if i in out["logits"]:
                mine = out["logits"][i][:len(served), :logits.shape[1]].to(device)
                mine = mine - mine.mean(-1, keepdim=True)
                theirs = logits - logits.mean(-1, keepdim=True)
                err2 += float((mine - theirs).square().sum())
                norm2 += float(theirs.square().sum())
        del w
    _free(device)
    mean = gap_sum / served_tokens if served_tokens else math.inf
    rel = math.sqrt(err2 / norm2) if norm2 > 0 else math.inf
    _log(reference_s=time.perf_counter() - t, reference_clips=len(sample), gaps=str(gaps),
         mean_gap=mean, logit_rel_err=rel)
    return {"clips": len(sample), "tokens": served_tokens, "gaps": gaps, "mean_gap": mean,
            "rel_err": rel}


def _free(device) -> None:
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run(ctx) -> dict:
    state = setup(ctx)
    out = window(ctx, state)
    spec = state["spec"]
    del state
    _free(ctx.device)
    sample = score(ctx, spec, out)
    attempted, finished = len(out["anns"]), len(out["finished"])
    readings = {"logit_gap": max(sample["gaps"]) if sample["gaps"] else math.inf,
                "logit_rel_err": sample["rel_err"]}
    checks = {name: (readings[name], limit) for name, limit in ctx.cell["limits"].items()}
    checks.update({
        "text_mismatches": (out["text_mismatch"], 0),
        "missing_clips": (attempted - finished, 0),
    })
    return {"attempted": attempted, "failed": attempted - finished, "checks": checks,
            "end_to_end": out["end_to_end"], "memory_peak_bytes": out["memory_peak_bytes"],
            "record": dict(out["record"], sample=sample)}


def _served_len(row) -> int:
    """Served ids up to and including the first EOS (the rest is fill)."""
    from portbench.reference.common import EOS

    hits = np.flatnonzero(row == EOS)
    return int(hits[0]) + 1 if len(hits) else len(row)
