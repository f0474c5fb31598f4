"""Batched decoding over a preallocated KV cache: greedy, grammar-
constrained with forced-token speculation, and lookup self-speculation.

The prefill writes the whole multimodal prefix into the cache, in
segments of ``cfg.prefill_chunk`` tokens (one pass when 0 or when the
prefix fits); then a Python loop runs one model pass per iteration until
every row has finished or the token budget is spent — one host check per
pass.  Finished rows keep emitting EOS, so the output buffer's tail is
EOS-filled.  Inside each decoder's ``decode`` profiler span, each pass's
launches and token bookkeeping are a ``decode.pass`` span and each host
check a ``decode.sync`` span (``utils/profiling.py`` lists the spans).

Every decoder allocates ``s + max_new_tokens + MAX_SPEC_WIDTH`` cache
columns (the speculative drafts may overhang the budget by up to their
width; overhanging columns are written but never committed).  With one
cache length for all three, the attention's tiles over the cache — and
so every committed token's arithmetic — do not depend on which decoder
runs: lookup decoding gives greedy's tokens, and grammar decoding at any
``spec_width`` gives the tokens of ``spec_width=1``.

Under ``cfg.kv_keep`` the prefill scores every column (SnapKV's
observation window, the prefix's last ``kv_keep_obs`` queries) and each
decoder compacts the cache to ``keep + max_new_tokens + MAX_SPEC_WIDTH``
columns before its loop (``models/llama.py::compact_cache``): the same
one-shape rule, with ``keep`` in place of ``s``.
"""

from __future__ import annotations

import time

import torch

from mraudio_tpu_torch.models.layers import NEG_INF
from mraudio_tpu_torch.models.llama import LlamaModel, compact_cache, init_cache
from mraudio_tpu_torch.utils.profiling import annotate

# the widest speculative draft (one query tile of chunked_attention)
MAX_SPEC_WIDTH = 16


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
    Under ``cfg.kv_keep`` each layer's cache also gets ``obs_score``, the
    observation window's column scores, summed over the segments.
    ``stats``, if given, receives ``prefill_segments``."""
    b, s, _ = prefix_embeds.shape
    chunk = model.cfg.prefill_chunk
    starts = list(range(0, s, chunk)) if chunk and s > chunk else [0]
    obs_start = s - min(model.cfg.kv_keep_obs, s) if model.cfg.kv_keep > 0 else None
    dev = prefix_embeds.device
    cache = init_cache(model.cache_cfg, b, alloc_len, dev)
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
                              return_hidden=True, obs_start=obs_start)
    if stats is not None:
        stats["prefill_segments"] = len(starts)
    return hidden, cache


def _prefill(model: LlamaModel, prefix_embeds, prefix_mask, max_new_tokens: int,
             stats: dict | None):
    """The shared prefill, inside the ``prefill`` profiler span: returns
    ``(last position (B,), cache-column mask (B, alloc_len), cache,
    last-position f32 logits (B, V), the clock at its end, the first
    decode column)``.  Under ``cfg.kv_keep`` the cache comes compacted to
    ``keep`` prefix columns (the first decode column), the mask covering
    them; each layer's ``valid`` leaf refines it.  ``stats`` receives
    ``prefill_s``, ``prefill_segments`` and ``prefill_logits``."""
    b, s, _ = prefix_embeds.shape
    dev = prefix_embeds.device
    alloc_len = s + max_new_tokens + MAX_SPEC_WIDTH
    t0 = time.perf_counter()
    with annotate("prefill"):
        positions = (torch.cumsum(prefix_mask.to(torch.int32), dim=-1) - 1).clamp_min(0)
        full_mask = torch.zeros((b, alloc_len), dtype=torch.int32, device=dev)
        full_mask[:, :s] = prefix_mask
        hidden, cache = prefill_cache(model, prefix_embeds, positions, full_mask, alloc_len,
                                      stats=stats)
        last_logits = model.logits(hidden[:, -1:])[:, -1]
        if model.cfg.kv_keep:
            extra = alloc_len - s
            cache = compact_cache(model.cfg, cache, full_mask, s, extra)
            s = min(model.cfg.kv_keep, s)
            full_mask = torch.zeros((b, s + extra), dtype=torch.int32, device=dev)
            full_mask[:, :s] = 1
        t1 = t0
        if stats is not None:
            _sync(dev)
            t1 = time.perf_counter()
            stats["prefill_s"] = t1 - t0
            stats["prefill_logits"] = last_logits
    return positions[:, -1], full_mask, cache, last_logits, t1, s


def _finished(done) -> bool:
    """The per-pass host check that every row has finished, inside the
    ``decode.sync`` span: the host waits here for the pass it launched."""
    with annotate("decode.sync"):
        return bool(done.all())


def _decode_stats(stats: dict | None, dev, t1: float, passes: int, emitted=None) -> None:
    if stats is not None:
        _sync(dev)
        stats["decode_s"] = time.perf_counter() - t1
        stats["decode_steps"] = passes
        if emitted is not None:
            stats["decode_tokens"] = [int(e) for e in emitted.tolist()]


@torch.inference_mode()
def greedy_generate(model: LlamaModel, prefix_embeds, prefix_mask,
                    max_new_tokens: int, eos_id: int, stats: dict | None = None):
    """Generated ids (B, max_new_tokens), EOS-filled after each row ends.

    ``stats``, if given, receives ``prefill_s``, ``decode_s`` (wall
    seconds, the device synchronised at each boundary),
    ``prefill_segments``, ``decode_steps``
    (decoder calls after the prefill) and ``prefill_logits`` (the f32
    last-position logits that seed the decode).  The two phases run
    inside profiler spans named ``prefill`` and ``decode``, the latter
    holding one ``decode.pass`` span per decoder call and a
    ``decode.sync`` span per host check."""
    b = prefix_embeds.shape[0]
    dev = prefix_embeds.device
    cur_pos, mask, cache, last_logits, t1, s = _prefill(model, prefix_embeds, prefix_mask,
                                                        max_new_tokens, stats)
    cur_id = last_logits.argmax(dim=-1).to(torch.int32)
    with annotate("decode"):
        tokens = torch.full((b, max_new_tokens), eos_id, dtype=torch.int32, device=dev)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        t = 0
        while t < max_new_tokens and not _finished(done):
            with annotate("decode.pass"):
                tokens[:, t] = torch.where(done, eos_id, cur_id)
                mask[:, s + t] = 1
                embeds = model.embed(cur_id[:, None])
                logits, cache = model(embeds, mask[:, None, None, :].bool(),
                                      (cur_pos + 1)[:, None], cache=cache, cache_index=s + t,
                                      kv_valid=mask)
                nxt = logits[:, -1].argmax(dim=-1).to(torch.int32)
                done = done | (cur_id == eos_id)
                cur_id = torch.where(done, eos_id, nxt)
                cur_pos = cur_pos + 1
            t += 1
        _decode_stats(stats, dev, t1, t)
    return tokens


def _draft_pass(model: LlamaModel, cache, mask, draft_ids, s: int, emitted, cur_pos,
                return_hidden: bool):
    """One model pass over the W draft positions of every row, at the
    row's own cache columns ``[s + emitted_b, s + emitted_b + W)``;
    returns ``(logits or hidden (B, W, ...), cache, those columns)``."""
    dev = draft_ids.device
    w = draft_ids.shape[1]
    jpos = torch.arange(w, device=dev)[None, :]
    kcols = torch.arange(mask.shape[1], device=dev)[None, :]
    start_col = s + emitted                                            # (B,)
    cols = start_col[:, None] + jpos                                   # (B, W)
    draft_window = (kcols >= start_col[:, None]) & (kcols < (start_col + w)[:, None])
    attend_valid = (mask > 0) | draft_window                           # (B, KV)
    # the materialized route's mask: per-row causal against absolute
    # columns (chunked_attention gets the same from kv_valid and q_abs)
    mask4 = attend_valid[:, None, None, :] & (kcols[:, None, None, :] <= cols[:, None, :, None])
    out, cache = model(model.embed(draft_ids), mask4, (cur_pos + 1)[:, None] + jpos,
                       cache=cache, cache_index=start_col,
                       kv_valid=attend_valid.to(torch.int32), causal=True,
                       return_hidden=return_hidden)
    return out, cache, cols


def _commit(tokens, mask, draft_ids, cols, emitted, accept, eos_id: int):
    """Write each row's first ``accept`` draft tokens after its committed
    ones and mark their cache columns valid; returns the commit mask."""
    w = draft_ids.shape[1]
    jpos = torch.arange(w, device=draft_ids.device)[None, :]
    commit = jpos < accept[:, None]                                    # (B, W)
    # uncommitted positions all write EOS to the buffer's last column
    out_col = torch.where(commit, emitted[:, None] + jpos, tokens.shape[1] - 1)
    tokens.scatter_(1, out_col, torch.where(commit, draft_ids, eos_id))
    mask.scatter_(1, cols, torch.maximum(mask.gather(1, cols), commit.to(mask.dtype)))
    return commit


@torch.inference_mode()
def grammar_generate(model: LlamaModel, prefix_embeds, prefix_mask, max_new_tokens: int,
                     eos_id: int, allowed, next_state, forced, dist_next,
                     spec_width: int = 4, stats: dict | None = None):
    """Grammar-constrained greedy decoding with forced-token speculation
    (the JAX package's ``grammar_generate``).

    Every token is masked to the span grammar (``text/grammar.py``
    tables on the device: ``allowed`` (NS, V) bool, ``next_state`` and
    ``dist_next`` (NS, V) int32, ``forced`` (NS,) int32), and to the
    tokens whose grammar continuation still fits the remaining budget
    (all allowed tokens when none does), so every output parses.  Each
    pass commits one free-choice token plus up to ``spec_width - 1``
    grammar-forced tokens after it, in one model pass over their
    positions; the next free token is picked from the logits at the last
    committed position.  Tokens are identical to ``spec_width=1``.

    Returns ids (B, max_new_tokens), EOS-filled after each row's end.
    ``stats`` as :func:`greedy_generate`'s, ``decode_steps`` counting
    model passes, plus ``decode_tokens`` (committed tokens per row)."""
    w = spec_width
    if not 1 <= w <= MAX_SPEC_WIDTH:
        raise ValueError(f"spec_width {w}: 1..{MAX_SPEC_WIDTH}")
    b = prefix_embeds.shape[0]
    dev = prefix_embeds.device
    cur_pos, mask, cache, last_logits, t1, s = _prefill(model, prefix_embeds, prefix_mask,
                                                        max_new_tokens, stats)

    def masked_pick(states, logits_bv, remaining):
        """Grammar and budget mask, then argmax; ``remaining`` (B,):
        tokens of budget left for the pick and its continuation."""
        al = allowed[states]                                           # (B, V)
        ok = al & (dist_next[states] <= (remaining - 1)[:, None])
        ok = torch.where(ok.any(dim=-1, keepdim=True), ok, al)
        return torch.where(ok, logits_bv, NEG_INF).argmax(dim=-1).to(torch.int32)

    with annotate("decode"):
        start = torch.zeros(b, dtype=torch.int32, device=dev)         # the DFA's start state
        cur_id = masked_pick(start, last_logits,
                             torch.full((b,), max_new_tokens, dtype=torch.int64, device=dev))
        g = next_state[start, cur_id]
        tokens = torch.full((b, max_new_tokens + w), eos_id, dtype=torch.int32, device=dev)
        emitted = torch.zeros(b, dtype=torch.int64, device=dev)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        it = 0
        while it < max_new_tokens and not _finished(done):
            with annotate("decode.pass"):
                # 1. the draft: the free token, then grammar-forced tokens
                draft, states = [cur_id], [g]
                ok = ~done
                cur_g = g
                n_valid = ok.to(torch.int64)
                for _ in range(w - 1):
                    f = forced[cur_g]
                    ok = ok & (f >= 0)
                    draft.append(torch.where(ok, f, eos_id))
                    cur_g = torch.where(ok, next_state[cur_g, f.clamp_min(0)], cur_g)
                    states.append(cur_g)
                    n_valid = n_valid + ok
                draft_ids = torch.stack(draft, dim=1)                  # (B, W)
                states_arr = torch.stack(states, dim=1)
                accept = torch.minimum(n_valid, max_new_tokens - emitted)
                # 2. one pass over the draft positions
                hidden, cache, cols = _draft_pass(model, cache, mask, draft_ids, s, emitted,
                                                  cur_pos, return_hidden=True)
                # 3. commit; the next free token comes from the last
                #    accepted position's logits
                commit = _commit(tokens, mask, draft_ids, cols, emitted, accept, eos_id)
                last = (accept - 1).clamp_min(0)
                g_last = states_arr.gather(1, last[:, None])[:, 0]
                h_last = hidden.gather(1, last[:, None, None].expand(-1, 1, hidden.shape[-1]))
                logit_last = model.logits(h_last)[:, 0]
                emitted = emitted + accept
                nxt = masked_pick(g_last, logit_last, max_new_tokens - emitted)
                done = (done | (commit & (draft_ids == eos_id)).any(dim=1)
                        | (emitted >= max_new_tokens))
                cur_id = torch.where(done, eos_id, nxt)
                g = torch.where(done, g_last, next_state[g_last, cur_id])
                cur_pos = cur_pos + accept
            it += 1
        _decode_stats(stats, dev, t1, it, emitted)
    return tokens[:, :max_new_tokens]


def lookup_draft(tokens, emitted, cur_id, spec_width: int, hint_ids=None, hint_mask=None):
    """(B, W-1) draft guesses for exact self-speculation (the JAX
    package's ``lookup_draft``): the continuation after the most recent
    earlier occurrence of ``cur_id`` among each row's committed tokens;
    failing that, after its most recent occurrence in the row's
    ``hint_ids`` stream (prompt lookup, ``hint_mask`` marking valid
    entries); failing both, ``cur_id`` repeated.  Guesses past the
    committed region or the hints fall back to ``cur_id`` too.  The draft
    moves only the speed, never the tokens."""
    w = spec_width
    b, length = tokens.shape
    dev = tokens.device
    rows = torch.arange(b, device=dev)[:, None]
    hpos = torch.arange(length, device=dev)[None, :]
    offs_w = 1 + torch.arange(w - 1, device=dev)[None, :]

    committed = hpos < emitted[:, None]
    hit = committed & (tokens == cur_id[:, None])
    any_hist = hit.any(dim=-1)
    j = torch.where(hit, hpos, -1).argmax(dim=-1)                     # most recent hit
    offs = j[:, None] + offs_w
    cont = tokens[rows, offs.clamp_max(length - 1)]
    usable = (offs < emitted[:, None]) & any_hist[:, None]
    guesses = torch.where(usable, cont, cur_id[:, None])

    if hint_ids is not None:
        n = hint_ids.shape[1]
        xpos = torch.arange(n, device=dev)[None, :]
        valid = hint_mask > 0 if hint_mask is not None else torch.ones_like(hint_ids, dtype=bool)
        xhit = valid & (hint_ids == cur_id[:, None])
        any_hint = xhit.any(dim=-1)
        xj = torch.where(xhit, xpos, -1).argmax(dim=-1)
        xoffs = xj[:, None] + offs_w
        xcol = xoffs.clamp_max(n - 1)
        xusable = (xoffs < n) & valid[rows, xcol] & any_hint[:, None]
        xguess = torch.where(xusable, hint_ids[rows, xcol].to(cur_id.dtype), cur_id[:, None])
        # generated history, where it has any match, wins over the prompt
        guesses = torch.where(any_hist[:, None], guesses, xguess)
    return guesses


@torch.inference_mode()
def lookup_generate(model: LlamaModel, prefix_embeds, prefix_mask, max_new_tokens: int,
                    eos_id: int, spec_width: int = 4, hint_ids=None, hint_mask=None,
                    stats: dict | None = None):
    """Greedy decoding with lookup self-speculation (the JAX package's
    ``lookup_generate``): tokens identical to :func:`greedy_generate`.

    Each pass drafts ``spec_width - 1`` tokens after the current one
    (:func:`lookup_draft`, with the optional (B, H) ``hint_ids`` /
    ``hint_mask`` prompt stream), runs one model pass over all W
    positions, and commits the draft prefix the model's own argmax agrees
    with plus the model's next token, stopping at the first EOS and at
    the budget.  ``stats`` as :func:`grammar_generate`'s."""
    w = spec_width
    if not 2 <= w <= MAX_SPEC_WIDTH:
        raise ValueError(f"spec_width {w}: 2..{MAX_SPEC_WIDTH}")
    b = prefix_embeds.shape[0]
    dev = prefix_embeds.device
    cur_pos, mask, cache, last_logits, t1, s = _prefill(model, prefix_embeds, prefix_mask,
                                                        max_new_tokens, stats)
    cur_id = last_logits.argmax(dim=-1).to(torch.int32)
    with annotate("decode"):
        tokens = torch.full((b, max_new_tokens + w), eos_id, dtype=torch.int32, device=dev)
        emitted = torch.zeros(b, dtype=torch.int64, device=dev)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        it = 0
        while it < max_new_tokens and not _finished(done):
            with annotate("decode.pass"):
                guesses = lookup_draft(tokens, emitted, cur_id, w, hint_ids, hint_mask)
                draft_ids = torch.cat([cur_id[:, None], guesses], dim=1)   # (B, W)
                logits, cache, cols = _draft_pass(model, cache, mask, draft_ids, s, emitted,
                                                  cur_pos, return_hidden=False)
                model_next = logits.argmax(dim=-1).to(torch.int32)     # (B, W)
                # draft[i + 1] commits iff it is the model's argmax after
                # draft[i] and everything before it committed
                agree = model_next[:, :w - 1] == draft_ids[:, 1:]
                n_agree = torch.cumprod(agree.to(torch.int64), dim=1).sum(dim=1)
                budget = (max_new_tokens - emitted).clamp_min(0)
                accept = torch.where(done, 0, torch.minimum(1 + n_agree, budget))
                is_eos = draft_ids == eos_id
                first_eos_len = (torch.cumsum(is_eos.to(torch.int64), dim=1) == 0).sum(dim=1) + 1
                accept = torch.minimum(accept, first_eos_len)
                commit = _commit(tokens, mask, draft_ids, cols, emitted, accept, eos_id)
                last = (accept - 1).clamp_min(0)
                nxt = model_next.gather(1, last[:, None])[:, 0]
                emitted = emitted + accept
                done = done | (commit & is_eos).any(dim=1) | (emitted >= max_new_tokens)
                cur_id = torch.where(done, eos_id, nxt)
                cur_pos = cur_pos + accept
            it += 1
        _decode_stats(stats, dev, t1, it, emitted)
    return tokens[:, :max_new_tokens]
