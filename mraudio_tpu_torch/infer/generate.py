"""Batched greedy decoding over a preallocated KV cache.

The prefill writes the whole multimodal prefix into the cache, in
segments of ``cfg.prefill_chunk`` tokens (one pass when 0 or when the
prefix fits), then a Python loop steps the decoder until every
row has emitted EOS or ``max_new_tokens`` is reached — one host check
per step.  Finished rows keep emitting EOS, so the output buffer's tail
is EOS-filled.
"""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from mraudio_tpu_torch.models.llama import LlamaModel, init_cache


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prefill_cache(model: LlamaModel, prefix_embeds, positions, full_mask, alloc_len: int,
                  stats: dict | None = None):
    """Run the prefix through the decoder, writing a fresh KV cache of
    ``alloc_len`` columns; returns ``(hidden, cache)``, ``hidden`` being
    the last segment's.

    With ``cfg.prefill_chunk`` the pass runs in segments: segment ``i``
    writes cache columns ``[o, o + c)`` and attends everything written
    so far (``cache_index=o``, the attention's static query offset).
    ``stats``, if given, receives ``prefill_segments``."""
    b, s, _ = prefix_embeds.shape
    chunk = model.cfg.prefill_chunk
    starts = list(range(0, s, chunk)) if chunk and s > chunk else [0]
    dev = prefix_embeds.device
    cache = init_cache(model.cfg, b, alloc_len, dev)
    k_idx = torch.arange(alloc_len, device=dev)
    pad = full_mask[:, None, None, :].bool()
    hidden = None
    for o in starts:
        c = min(chunk, s - o) if len(starts) > 1 else s
        q_idx = torch.arange(o, o + c, device=dev)
        # absolute causal + padding; columns past this segment are
        # unwritten and masked out of kv_valid too
        attend = (k_idx[None, :] <= q_idx[:, None])[None, None] & pad
        written = full_mask * (k_idx < o + c).to(full_mask.dtype)[None, :]
        hidden, cache = model(prefix_embeds[:, o:o + c], attend, positions[:, o:o + c],
                              cache=cache, cache_index=o, kv_valid=written, causal=True,
                              return_hidden=True)
    if stats is not None:
        stats["prefill_segments"] = len(starts)
    return hidden, cache


@torch.inference_mode()
def greedy_generate(model: LlamaModel, prefix_embeds, prefix_mask,
                    max_new_tokens: int, eos_id: int, stats: dict | None = None):
    """Generated ids (B, max_new_tokens), EOS-filled after each row ends.

    ``stats``, if given, receives ``prefill_s``, ``decode_s`` (wall
    seconds, the device synchronised at each boundary),
    ``prefill_segments``, ``decode_steps``
    (decoder calls after the prefill) and ``prefill_logits`` (the f32
    last-position logits that seed the decode).  The two phases run
    inside profiler spans named ``prefill`` and ``decode``."""
    b, s, _ = prefix_embeds.shape
    dev = prefix_embeds.device
    alloc_len = s + max_new_tokens
    t0 = time.perf_counter()

    with record_function("prefill"):
        positions = (torch.cumsum(prefix_mask.to(torch.int32), dim=-1) - 1).clamp_min(0)
        last_pos = positions[:, -1]
        full_mask = torch.zeros((b, alloc_len), dtype=torch.int32, device=dev)
        full_mask[:, :s] = prefix_mask

        hidden, cache = prefill_cache(model, prefix_embeds, positions, full_mask, alloc_len,
                                      stats=stats)
        last_logits = model.logits(hidden[:, -1:])
        cur_id = last_logits[:, -1].argmax(dim=-1).to(torch.int32)
        if stats is not None:
            _sync(dev)
            t1 = time.perf_counter()
            stats["prefill_s"] = t1 - t0
            stats["prefill_logits"] = last_logits[:, -1]

    with record_function("decode"):
        tokens = torch.full((b, max_new_tokens), eos_id, dtype=torch.int32, device=dev)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        cur_pos = last_pos
        mask = full_mask
        t = 0
        while t < max_new_tokens and not bool(done.all()):
            tokens[:, t] = torch.where(done, eos_id, cur_id)
            mask[:, s + t] = 1
            embeds = model.embed(cur_id[:, None])
            logits, cache = model(embeds, mask[:, None, None, :].bool(), (cur_pos + 1)[:, None],
                                  cache=cache, cache_index=s + t, kv_valid=mask)
            nxt = logits[:, -1].argmax(dim=-1).to(torch.int32)
            done = done | (cur_id == eos_id)
            cur_id = torch.where(done, eos_id, nxt)
            cur_pos = cur_pos + 1
            t += 1
        if stats is not None:
            _sync(dev)
            stats["decode_s"] = time.perf_counter() - t1
            stats["decode_steps"] = t
    return tokens
