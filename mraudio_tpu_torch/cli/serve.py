"""Serving CLI: continuous-batched moment retrieval over a request
stream (the JAX package's ``cli/serve.py``).

    python -m mraudio_tpu_torch.cli.serve --annotation-file A.jsonl \\
        [--output-file P.jsonl] [--model-size full|tiny] [--device cuda|cpu]

Each annotation becomes a request: its clip is encoded (encoders and
interleave, ``XInstructBLIP.prefix_and_prompt``), prefilled into a free
decode slot of ``infer/serving.py::ContinuousBatcher`` and decoded
continuously; a finished slot frees at once.  Prints one JSON line of
stats (requests/s, latency percentiles, prefill and decode seconds).
Requests arrive all at once (burst), on a seeded Poisson process
(``--arrival-rate``, load mode, latency from arrival) or are encoded
inside the serve loop (``--encode-mode inline``).  ``--device``
defaults to ``cuda`` (asking for it without a card raises); weights are
random from ``train.seed``.  Flags whose machinery is not ported raise
``NotImplementedError`` naming the ROADMAP.md item that brings it.
"""

from __future__ import annotations

import argparse
import json
import logging
import queue
import threading
import time
from collections import deque

import numpy as np
import torch

logger = logging.getLogger("mraudio_tpu_torch")

# flag → the ROADMAP.md item that ports its machinery
_UNPORTED = {
    "model_path": "A.8: tooling (converted weights)",
    "audio_encoder": "A.8: tooling (converted weights)",
    "params_store": "A.8: tooling (param store)",
    "checkpoint": "A.5: training (checkpoints)",
    "quant_encoders": "A.2: models/quant_tree.py",
}


def encode_request_stream(model, dataset, limit=None, device_embeds=True, encode_batch=1,
                          host_ahead=1, upload_ahead=False):
    """``(Request, annotation)`` pairs, one at a time, so that the serve
    loop can interleave encodes with decode passes.

    ``encode_batch`` requests share one encoder pass; a short tail group
    is padded by repeating its last sample (its outputs are dropped).
    ``host_ahead`` groups have their host stage (sample synthesis or
    decode, collate, tokenization) prepared ahead by a worker thread; the
    device stage (upload, encoder pass) stays on the consumer's thread, so
    no extra device-resident prefix is buffered.  ``upload_ahead`` lets the
    worker also start each group's video and audio uploads (pinned, non-
    blocking, on the consumer's device); a failed upload falls back to the
    lazy one.  ``device_embeds`` keeps each prefix on the device (else a
    host copy).  The records are the same whatever these settings."""
    from mraudio_tpu_torch.data.dataset import collate
    from mraudio_tpu_torch.infer.serving import Request, upload

    n = len(dataset) if limit is None else min(limit, len(dataset))
    eb = max(1, encode_batch)
    device = model.device

    def host_batches():
        if device.type == "cuda":
            torch.cuda.set_device(device)
        for g0 in range(0, n, eb):
            idx = list(range(g0, min(g0 + eb, n)))
            padded = idx + [idx[-1]] * (eb - len(idx))
            batch = collate([dataset.get(i) for i in padded], len(padded))
            text = model.prepare_text(batch.text_input, np.asarray(batch.timestamps),
                                      batch.duration)
            dev = None
            if upload_ahead:
                try:
                    dev = (upload(model._wire_video(batch.video), device),
                           upload(np.asarray(batch.audio), device))
                except torch.cuda.OutOfMemoryError:
                    logger.warning("upload-ahead ran out of device memory; "
                                   "falling back to lazy upload for this group")
            yield idx, batch, text, dev

    groups = _PrefetchedStream(host_batches(), host_ahead) if host_ahead > 0 else host_batches()

    def device_stage(idx, batch, text, dev):
        video, audio = dev if dev is not None else model.device_inputs(batch)
        n_frms = batch.timestamps.shape[1]
        embeds, _ = model.prefix_and_prompt(
            video, audio, text.qformer_ids, text.qformer_mask, text.ts_ids, text.ts_mask,
            text.dur_ids, text.dur_mask, text.prompt_ids, text.prompt_mask, n_frms=n_frms)
        # the host twin of the device mask: reading that back would wait
        # on the encoder pass and everything queued before it
        mask_h = model.prefix_mask_host(text, n_frms)
        for k, i in enumerate(idx):
            emb = embeds[k] if device_embeds else embeds[k].cpu()
            # prompt-lookup hints for speculative drafting: the request's
            # valid timestamp, duration and prompt token ids
            hints = np.concatenate([
                np.asarray(text.ts_ids)[k].reshape(-1)[np.asarray(text.ts_mask)[k].reshape(-1) > 0],
                np.asarray(text.dur_ids)[k][np.asarray(text.dur_mask)[k] > 0],
                np.asarray(text.prompt_ids)[k][np.asarray(text.prompt_mask)[k] > 0],
            ])
            logger.info("encoded request %d/%d", i + 1, n)
            yield Request(i, emb, mask_h[k], hint_ids=hints), dataset.annotation[i]

    return _EncodeStream(groups, device_stage,
                         groups if isinstance(groups, _PrefetchedStream) else None,
                         host_ahead if host_ahead > 0 else 0)


class _EncodeStream:
    """Iterator of ``(Request, ann)`` over encode groups, with the host
    prefetch's accounting (``host_ahead``, ``host_busy_s``) and the
    encode's out-of-memory backpressure: when ``serve`` installs
    ``oom_recover`` (drain every in-flight decode so its memory frees), a
    group whose device stage runs out of device memory is retried once,
    with the same result."""

    def __init__(self, groups, device_stage, prefetch, host_ahead: int):
        self._groups = groups
        self._device_stage = device_stage
        self._prefetch = prefetch
        self.host_ahead = host_ahead
        self.oom_recover = None
        self._buf = deque()

    @property
    def host_busy_s(self) -> float:
        return self._prefetch.busy_s if self._prefetch is not None else 0.0

    def __iter__(self):
        return self

    def __next__(self):
        while not self._buf:
            group = next(self._groups)           # StopIteration ends the stream
            try:
                items = list(self._device_stage(*group))
            except torch.cuda.OutOfMemoryError:
                if self.oom_recover is None:
                    raise
                logger.warning("encode ran out of device memory next to in-flight decode "
                               "state; draining the engine and retrying once")
                self.oom_recover()
                items = list(self._device_stage(*group))
            self._buf.extend(items)
        return self._buf.popleft()


def encode_requests(model, dataset, limit=None, device_embeds=False, encode_batch=1,
                    host_ahead=1, upload_ahead=False):
    """The whole request list encoded up front (host-resident prefixes by
    default)."""
    return list(encode_request_stream(model, dataset, limit=limit, device_embeds=device_embeds,
                                      encode_batch=encode_batch, host_ahead=host_ahead,
                                      upload_ahead=upload_ahead))


class _PrefetchedStream:
    """Bounded single-worker prefetch over an iterator: FIFO, order-
    preserving, the worker's exception raised on the consumer's side.
    ``busy_s`` sums the worker's seconds per item."""

    _DONE = object()

    def __init__(self, stream, ahead: int):
        self._q = queue.Queue(maxsize=max(1, ahead))
        self.busy_s = 0.0
        self._err = None

        def work():
            try:
                while True:
                    t0 = time.time()
                    item = next(stream, self._DONE)
                    self.busy_s += time.time() - t0
                    self._q.put(item)
                    if item is self._DONE:
                        return
            except BaseException as e:  # raised on the consumer's side
                self._err = e
                self._q.put(self._DONE)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def poisson_arrivals(n: int, rate: float, seed: int = 0) -> list:
    """Open-loop Poisson arrival offsets (seconds): ``n`` points with
    exponential gaps at ``rate`` requests/s, the first at 0; seeded."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n)
    gaps[0] = 0.0
    return np.cumsum(gaps).tolist()


def serve(model, requests, max_slots: int, max_new_tokens: int, max_prefill_batch: int = 0,
          steps_per_dispatch: int = 1, spec_width: int = 1, pipeline_depth: int = 2,
          encode_s: float = 0.0, request_stream=None, encode_batch: int = 1,
          engine_cache: dict | None = None, arrivals=None, request_timeout_s: float = 0.0):
    """Run the requests through the engine; returns ``(records, stats)``.

    ``requests``: a pre-encoded list of ``(Request, ann)`` (upfront mode;
    the encoder's seconds come in as ``encode_s``).  Or ``request_stream``,
    an iterator of the same pairs encoded inside the loop, at most one
    admission batch ahead (inline mode).  ``arrivals``: per-request arrival
    offsets in seconds (load mode, upfront only): a request becomes
    visible once its offset elapses and its latency counts from then.
    ``request_timeout_s``: a request older than this — queued, in
    admission or decoding — is cancelled and reported in
    ``stats["timeouts"]``.  ``engine_cache``: a caller's dict that keeps
    one engine across calls while its shape does not change."""
    from mraudio_tpu_torch.infer.serving import ContinuousBatcher
    from mraudio_tpu_torch.text.postprocess import moment_str_to_list, post_process

    scheduled: list = []
    if arrivals is not None:
        assert requests and len(arrivals) == len(requests), \
            "arrivals must align with a pre-encoded requests list"
        assert request_stream is None, "load mode is upfront-encoded"
        order = sorted(range(len(requests)), key=lambda i: arrivals[i])
        scheduled = [(float(arrivals[i]), requests[i]) for i in order]
        pending = []
        ann_by_id = {req.request_id: ann for req, ann in requests}
    else:
        pending = list(requests) if requests else []
        ann_by_id = {req.request_id: ann for req, ann in pending}
    inline = request_stream is not None
    stream_obj = request_stream
    prime_s = 0.0
    if inline:
        # one request sizes the engine; its encode overlaps nothing and
        # counts toward the elapsed time
        t0 = time.time()
        item = next(request_stream, None)
        prime_s = time.time() - t0
        if item is None:
            request_stream = None
        else:
            pending.append(item)
            ann_by_id[item[0].request_id] = item[1]
    if not pending and not scheduled:
        return [], {"requests": 0, "slots": max_slots, "elapsed_s": 0.0,
                    "requests_per_sec": 0.0, "encode_mode": "inline" if inline else "upfront"}
    first_req = (pending[0] if pending else scheduled[0][1])[0]
    prefix_len = first_req.prefix_embeds.shape[0]
    llm = model.llm
    eos = model.llm_tokenizer.eos_token_id
    engine_key = (prefix_len, max_new_tokens, max_slots, max_prefill_batch, steps_per_dispatch,
                  spec_width, pipeline_depth, id(llm), llm.cfg)
    engine = None
    if (engine_cache is not None and engine_cache.get("key") == engine_key
            and engine_cache.get("engine") is not None):
        engine = engine_cache["engine"]
        engine.reset()
    if engine is None:
        if engine_cache is not None:
            old = engine_cache.pop("engine", None)
            engine_cache.pop("key", None)
            if old is not None:
                old.close()
        engine = ContinuousBatcher(llm, prefix_len, max_new_tokens, eos, max_slots=max_slots,
                                   max_prefill_batch=max_prefill_batch,
                                   steps_per_dispatch=steps_per_dispatch, spec_width=spec_width,
                                   pipeline_depth=pipeline_depth)
        if engine_cache is not None:
            engine_cache["key"] = engine_key
            engine_cache["engine"] = engine

    try:
        submit_time, records = {}, []
        done = set()                 # completed or timed-out request ids
        t_start = time.time() - prime_s

        def handle(completion):
            done.add(completion.request_id)
            tokens = np.asarray(completion.token_ids)
            tokens[tokens == 0] = eos
            raw = model.llm_tokenizer.decode(tokens, skip_special_tokens=True).strip()
            ann = ann_by_id[completion.request_id]
            records.append({
                "qid": ann["qid"], "query": ann["query"], "vid": ann["vid"],
                "pred_relevant_windows": moment_str_to_list(post_process(raw)),
                "raw_out": raw,
                "latency_s": round(time.time() - submit_time[completion.request_id], 4),
            })

        if inline and hasattr(stream_obj, "oom_recover"):
            def _drain_for_encode():
                while engine.admission_pending():
                    engine.admission_step()
                while engine.active.any() or engine._inflight:
                    for completion in engine.step():
                        handle(completion)
                if model.device.type == "cuda":
                    torch.cuda.empty_cache()

            stream_obj.oom_recover = _drain_for_encode

        # a decode "step" is one engine dispatch with its token readback
        prefill_s = decode_s = inline_encode_s = 0.0
        prefill_calls = decode_steps = 0
        timeouts: list = []

        def enforce_timeouts(now):
            if not request_timeout_s:
                return
            overdue = [rid for rid, t in submit_time.items()
                       if now - t > request_timeout_s and rid not in done]
            for rid in overdue:
                done.add(rid)
                engine.cancel(rid)
                for k, (req, _) in enumerate(pending):
                    if req.request_id == rid:
                        del pending[k]
                        break
                ann = ann_by_id[rid]
                timeouts.append({"_rid": rid, "qid": ann["qid"], "vid": ann["vid"],
                                 "timeout_s": round(now - submit_time[rid], 3)})

        while (pending or scheduled or request_stream is not None or engine.active.any()
               or engine.admission_pending() or engine._inflight):
            now = time.time()
            if scheduled:
                while scheduled and t_start + scheduled[0][0] <= now:
                    off, item = scheduled.pop(0)
                    pending.append(item)
                    submit_time[item[0].request_id] = t_start + off
                if (not pending and not engine.active.any()
                        and not engine.admission_pending() and not engine._inflight):
                    # open-loop idle gap: sleep toward the next arrival
                    time.sleep(min(max(t_start + scheduled[0][0] - now, 0.0), 0.05)
                               if scheduled else 0.0)
                    continue
            enforce_timeouts(now)
            if (request_stream is not None and len(pending) < engine.max_prefill_batch
                    and not engine.admission_pending()):
                # encode ahead, at most one admission batch, never beside an
                # admission's batch cache
                t0 = time.time()
                item = next(request_stream, None)
                inline_encode_s += time.time() - t0
                if item is None:
                    request_stream = None
                else:
                    pending.append(item)
                    ann_by_id[item[0].request_id] = item[1]
            if engine.admission_pending():
                # one prefill segment per iteration: decode passes run between
                t0 = time.time()
                engine.admission_step()
                prefill_s += time.time() - t0
            else:
                # inline: wait for a full admission batch while the stream lives
                batch_ready = request_stream is None or len(pending) >= min(
                    engine.max_prefill_batch, max(engine.free_slots(), 1))
                if pending and engine.free_slots() and batch_ready:
                    now = time.time()
                    admitted = engine.begin_admission([req for req, _ in pending])
                    prefill_s += time.time() - now
                    if admitted:
                        prefill_calls += 1
                        for req, _ in pending[:admitted]:
                            # load mode: the clock started at arrival
                            submit_time.setdefault(req.request_id, now)
                        del pending[:admitted]
            if engine.active.any() or engine._inflight:
                t0 = time.time()
                completions = engine.step()
                decode_s += time.time() - t0
                decode_steps += 1
                for completion in completions:
                    handle(completion)
        elapsed = time.time() - t_start

        lat = np.array([r["latency_s"] for r in records] or [0.0])
        stats = {
            "requests": len(records),
            "slots": max_slots,
            "max_prefill_batch": engine.max_prefill_batch,
            "kv_keep": engine.kv_keep,
            "steps_per_dispatch": engine.steps_per_dispatch,
            "spec_width": engine.spec_width,
            "pipeline_depth": engine.pipeline_depth,
            "elapsed_s": round(elapsed, 2),
            "requests_per_sec": round(len(records) / elapsed, 4),
            "latency_p50_s": round(float(np.percentile(lat, 50)), 3),
            "latency_p95_s": round(float(np.percentile(lat, 95)), 3),
            "prefill_s": round(prefill_s, 2),
            "prefill_calls": prefill_calls,
            # upfront: requests_per_sec covers the engine and the rate with
            # encode adds the separate encoder pass; inline: both include it
            "encode_mode": "inline" if inline else "upfront",
            "encode_batch": encode_batch,
            "encode_ahead": getattr(stream_obj, "host_ahead", 0) if inline else 0,
            "encode_s": round((inline_encode_s + prime_s) if inline else encode_s, 2),
            **({"encode_busy_s": round(stream_obj.host_busy_s, 2)}
               if inline and getattr(stream_obj, "host_ahead", 0) else {}),
            "requests_per_sec_incl_encode": (
                round(len(records) / (elapsed + (0.0 if inline else encode_s)), 4)
                if (elapsed + encode_s) > 0 else 0.0),
            "decode_s": round(decode_s, 2),
            "decode_steps": decode_steps,
            "sec_per_decode_step": round(decode_s / decode_steps, 4) if decode_steps else 0.0,
        }
        if arrivals is not None:
            span = max(arrivals) - min(arrivals) if len(arrivals) > 1 else 0.0
            stats["load"] = {"offered_rps": round((len(arrivals) - 1) / span, 4) if span else 0.0,
                             "latency_from": "arrival"}
        if request_timeout_s:
            stats["request_timeout_s"] = request_timeout_s
            stats["timeouts"] = len(timeouts)
            stats["timed_out"] = [{k: v for k, v in t.items() if k != "_rid"} for t in timeouts]
    except BaseException:
        # a failed pass may leave the engine half-updated: evict and free it
        if engine_cache is not None and engine_cache.get("engine") is engine:
            engine_cache.pop("engine", None)
            engine_cache.pop("key", None)
        engine.close()
        raise
    if engine_cache is None:
        engine.close()
    return records, stats


def main(argv=None):
    parser = argparse.ArgumentParser(description="mraudio_tpu_torch serving CLI")
    parser.add_argument("--model", default="X-InstructBLIP")
    parser.add_argument("--model-path", default="", help="converted LLM weights dir")
    parser.add_argument("--checkpoint", default="", help="trained checkpoint dir to overlay")
    parser.add_argument("--params-store", default="", help="prebuilt param store")
    parser.add_argument("--audio-encoder", default="", help="converted BEATs weights")
    parser.add_argument("--video-folder", default="")
    parser.add_argument("--annotation-file", required=True)
    parser.add_argument("--output-file", default="")
    parser.add_argument("--config", default="", help="YAML RunConfig path")
    parser.add_argument("--video-source", default="", choices=["", "native", "synthetic", "npy"])
    parser.add_argument("--model-size", default="full", choices=["full", "tiny"])
    parser.add_argument("--n-frms", type=int, default=0)
    parser.add_argument("--slots", type=int, default=4)
    parser.add_argument("--max-prefill-batch", type=int, default=0,
                        help="cap the batched-admission prefill width (0 = up to --slots)")
    parser.add_argument("--max-requests", type=int, default=0)
    parser.add_argument("--kv-keep", type=int, default=0,
                        help="SnapKV slot-cache compaction to the top-N prefix columns per "
                             "layer (an approximation)")
    parser.add_argument("--steps-per-dispatch", type=int, default=1,
                        help="decode micro-steps per engine step (token-identical; a finished "
                             "row holds its slot until the window ends)")
    parser.add_argument("--spec-width", type=int, default=1,
                        help="self-speculative width: each pass verifies W-1 lookup-drafted "
                             "tokens per slot (token-identical)")
    parser.add_argument("--pipeline-depth", type=int, default=2,
                        help="decode dispatches in flight on the greedy path: 2 reads each "
                             "dispatch's tokens one dispatch late; 1 reads them at once")
    parser.add_argument("--encode-mode", default="upfront", choices=["upfront", "inline"],
                        help="upfront: encode every request first and report the encoder "
                             "apart; inline: encode inside the serve loop, one admission "
                             "batch ahead")
    parser.add_argument("--encode-batch", type=int, default=0,
                        help="requests per encoder pass (0 = --max-prefill-batch, else --slots)")
    parser.add_argument("--encode-ahead", type=int, default=1,
                        help="encode host-stage groups prepared ahead by a worker thread "
                             "(0 = synchronous)")
    parser.add_argument("--upload-ahead", type=int, default=0,
                        help="1 = the worker also starts each group's input uploads")
    parser.add_argument("--embeds", default="auto", choices=["auto", "host", "device"],
                        help="where encoded prefixes wait for admission (auto: device inline, "
                             "host upfront)")
    parser.add_argument("--sweep-slots", default="",
                        help="comma-separated slot counts to run, e.g. 1,2,4")
    parser.add_argument("--arrival-rate", type=float, default=0.0,
                        help="load mode: Poisson arrivals at this rate (requests/s), latency "
                             "from arrival; 0 = burst")
    parser.add_argument("--arrival-seed", type=int, default=0)
    parser.add_argument("--request-timeout", type=float, default=0.0,
                        help="per-request deadline in seconds (0 = none)")
    parser.add_argument("--quant-encoders", action="store_true",
                        help="int8-store the frozen encoder weights")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda; cpu runs the plain "
                             "versions of the kernels)")
    args = parser.parse_args(argv)

    for flag, item in _UNPORTED.items():
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported yet (ROADMAP.md {item})")

    logging.basicConfig(level=logging.INFO)

    from mraudio_tpu_torch.cli.evaluate import build_config
    from mraudio_tpu_torch.data.dataset import MRDataset
    from mraudio_tpu_torch.infer.evaluate import build_model, refuse_unported
    from mraudio_tpu_torch.models.casting import cast_params_for_inference

    args.num_chunks, args.chunk_idx, args.dataset = 1, 0, "QVH"
    cfg = build_config(args)
    if args.kv_keep:
        cfg = cfg.replace(model=cfg.model.replace(
            llm=cfg.model.llm.replace(kv_keep=args.kv_keep)))
    refuse_unported(cfg)
    inline = args.encode_mode == "inline"
    if args.arrival_rate and inline:
        raise SystemExit("--arrival-rate is upfront-encoded load mode; use --encode-mode upfront")
    model = cast_params_for_inference(build_model(cfg, args.device))

    dataset = MRDataset(cfg.data, annotation_path=cfg.data.annotation_file, split="eval")
    limit = args.max_requests or None
    device_embeds = args.embeds == "device" or (args.embeds == "auto" and inline)
    encode_batch = args.encode_batch or args.max_prefill_batch or args.slots
    stream_kw = dict(limit=limit, device_embeds=device_embeds, encode_batch=encode_batch,
                     host_ahead=args.encode_ahead, upload_ahead=bool(args.upload_ahead))
    requests, encode_s = None, 0.0
    if not inline:
        t_enc = time.time()
        requests = encode_requests(model, dataset, **stream_kw)
        encode_s = time.time() - t_enc

    def run(slots):
        stream = encode_request_stream(model, dataset, **stream_kw) if inline else None
        arrivals = (poisson_arrivals(len(requests), args.arrival_rate, args.arrival_seed)
                    if args.arrival_rate and requests else None)
        return serve(model, requests, slots, model.cfg.max_new_tokens,
                     max_prefill_batch=args.max_prefill_batch,
                     steps_per_dispatch=args.steps_per_dispatch, spec_width=args.spec_width,
                     pipeline_depth=args.pipeline_depth, encode_s=encode_s,
                     request_stream=stream, encode_batch=encode_batch, arrivals=arrivals,
                     request_timeout_s=args.request_timeout)

    if args.sweep_slots:
        sweep = []
        for slots in (int(s) for s in args.sweep_slots.split(",")):
            _, stats = run(slots)
            print(json.dumps(stats))
            sweep.append(stats)
        return sweep

    records, stats = run(args.slots)
    if args.output_file:
        with open(args.output_file, "w") as f:
            for r in records:
                f.write(json.dumps(r) + "\n")
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
