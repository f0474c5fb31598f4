"""Slot-based continuous batching for moment-retrieval serving (the JAX
package's ``infer/serving.py``).

A serving deployment receives requests at arbitrary times.  The engine
keeps ``max_slots`` decode lanes in one shared KV cache on the device:

* new requests prefill together (``submit_many``, or ``begin_admission``
  then one prefill segment per ``admission_step``, so that decode passes
  run between segments) into a private batch cache, which the admission
  epilogue compacts under ``cfg.kv_keep`` and scatters into free slots;
* every engine step advances all active slots by one token (or by
  ``steps_per_dispatch`` tokens, or by a verified speculative draft of
  ``spec_width`` positions) in one decoder pass; slots stand at different
  cache columns (per-row ``cache_index``);
* a slot frees the moment its row ends, so a short answer never waits on
  the longest request in flight.

The greedy path keeps its row state (current token, position, valid
columns, write column) on the device: a dispatch chains off the previous
one's tensors and, at ``pipeline_depth`` 2, the host reads a dispatch's
tokens one dispatch late, from a pinned host copy behind a CUDA event, so
the readback overlaps the next dispatch.  The speculative path drafts on
the host from each slot's own tokens and so keeps its row state there.

The slot cache has ``slot_prefix + max_new_tokens + MAX_SPEC_WIDTH``
columns, the offline decoders' length (``infer/generate.py``): a
request's tokens are those of the offline greedy decoder.  The reference
jits and donates its buffers; here the cache is updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mraudio_tpu_torch.infer.generate import MAX_SPEC_WIDTH
from mraudio_tpu_torch.models.llama import LlamaModel, compact_cache, init_cache


def upload(a, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without waiting for the device: on CUDA
    through a pinned copy (the caching host allocator keeps it until the
    transfer ends)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


@dataclasses.dataclass
class Request:
    request_id: int
    # (S, D): a numpy array or a tensor; a tensor already on the device
    # (the serving encoder's output) is stacked there at admission
    prefix_embeds: object
    prefix_mask: np.ndarray     # (S,), host
    # optional prompt-lookup hint stream (valid token ids) for drafting
    hint_ids: Optional[np.ndarray] = None


@dataclasses.dataclass
class Completion:
    request_id: int
    token_ids: list


class ContinuousBatcher:
    """The engine over ``model``'s weights, on the model's device.

    ``max_prefill_batch`` caps an admission's width (0 = ``max_slots``);
    ``steps_per_dispatch`` decode micro-steps run per engine step (a row
    that ends inside a window holds its slot until the window ends);
    ``spec_width`` > 1 verifies ``spec_width - 1`` host-drafted tokens per
    slot and pass (exclusive with ``steps_per_dispatch`` > 1; runs at
    pipeline depth 1); ``pipeline_depth`` 2 reads each dispatch's tokens
    one dispatch late.  Every setting gives the same tokens.  A decoder
    with latent attention or routed experts raises."""

    @torch.inference_mode()
    def __init__(self, model: LlamaModel, prefix_len: int, max_new_tokens: int, eos_id: int,
                 max_slots: int = 4, max_prefill_batch: int = 0, steps_per_dispatch: int = 1,
                 spec_width: int = 1, pipeline_depth: int = 2):
        if model.cfg.attention_kind != "gqa" or model.cfg.n_routed_experts:
            raise NotImplementedError("the serving engine runs dense grouped-query decoders "
                                      "only: latent attention and routed experts are served "
                                      "by infer/generate.py's decoders")
        self.model = model
        self.device = model.final_norm.scale.device
        self.prefix_len = prefix_len
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.max_slots = max_slots
        self.max_prefill_batch = max_prefill_batch or max_slots
        self.steps_per_dispatch = max(1, steps_per_dispatch)
        cfg = model.cfg
        self.kv_keep = min(cfg.kv_keep, prefix_len) if cfg.kv_keep else 0
        self.spec_width = max(1, spec_width)
        if self.spec_width > MAX_SPEC_WIDTH:
            raise ValueError(f"spec_width {spec_width}: at most {MAX_SPEC_WIDTH}")
        if self.spec_width > 1 and self.steps_per_dispatch > 1:
            raise ValueError("spec_width > 1 and steps_per_dispatch > 1 are mutually exclusive: "
                             "speculative verify is itself the multi-position dispatch")
        if self.spec_width > 1:
            pipeline_depth = 1          # drafting reads every pass's tokens
        self.pipeline_depth = max(1, pipeline_depth)
        self._inflight: list[tuple] = []
        self.slot_prefix = self.kv_keep or prefix_len
        self.max_len = self.slot_prefix + max_new_tokens + MAX_SPEC_WIDTH
        # an admission's cache holds the whole prefix (compacted afterwards
        # under kv_keep) with the offline decoders' column count
        self._alloc = prefix_len + max_new_tokens + MAX_SPEC_WIDTH
        chunk = cfg.prefill_chunk
        if not chunk or prefix_len <= chunk:
            self._chunk_starts = [(0, prefix_len)]
        else:
            self._chunk_starts = [(o, min(chunk, prefix_len - o))
                                  for o in range(0, prefix_len, chunk)]
        # the SnapKV window: the offline prefill's (infer/generate.py)
        self._obs_start = (prefix_len - min(cfg.kv_keep_obs, prefix_len)
                           if cfg.kv_keep > 0 else None)
        self._admission: Optional[dict] = None
        self._reserved = np.zeros((max_slots,), bool)
        # request ids cancelled while their admission was in flight
        self._cancelled: set = set()

        dev = self.device
        self.cache = init_cache(cfg, max_slots, self.max_len, dev, valid=bool(self.kv_keep))
        # host row state: the speculative path
        self.valid = np.zeros((max_slots, self.max_len), np.int32)
        self.positions = np.zeros((max_slots,), np.int64)   # last RoPE position
        self.lengths = np.full((max_slots,), prefix_len, np.int64)  # next write column
        self.cur_ids = np.zeros((max_slots,), np.int32)
        # device row state: the pipelined greedy/window path
        self._rows = torch.arange(max_slots, device=dev)
        self.dvalid = torch.zeros((max_slots, self.max_len), dtype=torch.int32, device=dev)
        self.dpos = torch.zeros((max_slots,), dtype=torch.int64, device=dev)
        self.dlen = torch.full((max_slots,), self.slot_prefix, dtype=torch.int64, device=dev)
        self.dcur = torch.zeros((max_slots,), dtype=torch.int32, device=dev)
        self.emitted: list[list[int]] = [[] for _ in range(max_slots)]
        self.hints: list[Optional[np.ndarray]] = [None] * max_slots
        self.slot_request: list[Optional[int]] = [None] * max_slots
        self.active = np.zeros((max_slots,), bool)

    # ------------------------------------------------------------------

    def _embeds_on_device(self, e) -> torch.Tensor:
        if isinstance(e, torch.Tensor):
            return e.to(self.device)
        return upload(np.asarray(e), self.device)

    def _prefill_segment(self, ad: dict, o: int, c: int) -> None:
        """One prefill segment ``[o, o + c)`` of the admission batch, the
        offline ``prefill_cache``'s segment: the same attend mask, the
        written-columns ``kv_valid`` and the observation window."""
        dev = self.device
        k_idx = torch.arange(self._alloc, device=dev)
        q_idx = torch.arange(o, o + c, device=dev)
        pmask = ad["pmask"]
        attend = (k_idx[None, :] <= q_idx[:, None])[None, None] & pmask[:, None, None, :].bool()
        written = pmask * (k_idx < o + c).to(pmask.dtype)[None, :]
        ad["hidden"], _ = self.model(
            ad["embeds"][:, o:o + c], attend, ad["positions"][:, o:o + c], cache=ad["cache"],
            cache_index=o, kv_valid=written, causal=True, return_hidden=True,
            obs_start=self._obs_start)

    def _finish(self, ad: dict):
        """Admission epilogue: the last position's lm_head seeds each row's
        first token; under ``kv_keep`` the batch cache is compacted to the
        slot's column count."""
        logits = self.model.logits(ad["hidden"][:, -1:])[:, -1]
        first_ids = logits.argmax(dim=-1).to(torch.int32)
        cache = ad["cache"]
        if self.kv_keep:
            cache = compact_cache(self.model.cfg, cache, ad["pmask"], self.prefix_len,
                                  self.max_len - self.slot_prefix)
        return cache, first_ids

    def _write_slots(self, batch_cache: list, slots: torch.Tensor) -> None:
        """Every cache leaf of the first ``len(slots)`` batch rows into
        their slots (padded bucket rows are dropped)."""
        n = slots.shape[0]
        for layer, batch_layer in zip(self.cache, batch_cache):
            for name, dst in layer.items():
                dst.index_copy_(0, slots, batch_layer[name][:n].to(dst.dtype))

    def _decode_window(self, active: torch.Tensor) -> torch.Tensor:
        """``steps_per_dispatch`` greedy micro-steps of every slot; returns
        the tokens written at each micro-step (K, max_slots).  Inactive rows
        stay frozen: no valid column, position or length advances, and
        their cache writes land on a column that is never valid (admission
        overwrites the row)."""
        a = active.to(torch.int32)
        toks = []
        for _ in range(self.steps_per_dispatch):
            col = self.dlen.clamp_max(self.max_len - 1)
            self.dvalid[self._rows, col] = torch.maximum(self.dvalid[self._rows, col], a)
            embeds = self.model.embed(self.dcur[:, None])
            logits, _ = self.model(embeds, self.dvalid[:, None, None, :].bool(),
                                   (self.dpos + 1)[:, None], cache=self.cache, cache_index=col,
                                   kv_valid=self.dvalid)
            nxt = logits[:, -1].argmax(dim=-1).to(torch.int32)
            toks.append(self.dcur)
            # fresh tensors, never written in place: the tokens of a window
            # still waiting for its readback stay as they were
            self.dcur = torch.where(active, nxt, self.dcur)
            self.dpos = self.dpos + a
            self.dlen = self.dlen + a
        return torch.stack(toks)

    def _decode_spec(self, draft_ids, positions, valid, lengths, active) -> torch.Tensor:
        """One W-position verify pass over every slot's draft at its own
        columns ``[lengths_b, lengths_b + W)``; returns the model's argmax
        after each draft position (B, W).  The host decides what commits;
        uncommitted columns stay invalid and are overwritten later."""
        w = self.spec_width
        dev = self.device
        jpos = torch.arange(w, device=dev)[None, :]
        kcols = torch.arange(self.max_len, device=dev)[None, :]
        start = lengths.clamp_max(self.max_len - w)
        cols = start[:, None] + jpos
        draft_window = (kcols >= start[:, None]) & (kcols < (start + w)[:, None])
        attend_valid = (valid > 0) | (draft_window & active[:, None])
        mask4 = attend_valid[:, None, None, :] & (kcols[:, None, None, :] <= cols[:, None, :, None])
        logits, _ = self.model(self.model.embed(draft_ids), mask4, (positions + 1)[:, None] + jpos,
                               cache=self.cache, cache_index=start,
                               kv_valid=attend_valid.to(torch.int32), causal=True)
        return logits.argmax(dim=-1).to(torch.int32)

    # ------------------------------------------------------------------

    def free_slots(self) -> int:
        return int((~self.active & ~self._reserved).sum())

    def submit(self, request: Request) -> bool:
        """Prefill a request into a free slot.  False if no slot is free."""
        return self.submit_many([request]) == 1

    def submit_many(self, requests: list) -> int:
        """Admit up to ``free_slots()`` of ``requests`` in one batched
        prefill, running every segment now.  Returns how many were admitted
        (a prefix of the list).  ``begin_admission`` + ``admission_step``
        is the incremental twin, with the same tokens."""
        n = self.begin_admission(requests)
        while self._admission is not None:
            self.admission_step()
        return n

    def admission_pending(self) -> bool:
        return self._admission is not None

    @torch.inference_mode()
    def begin_admission(self, requests: list) -> int:
        """Reserve slots and stack the embeds of up to
        ``max_prefill_batch`` requests; returns the admitted count (0 while
        an admission is in flight).  The batch is padded to a power of two
        by repeating the last row (an all-zero mask row would give a
        softmax of nothing); padded rows never reach the slot cache."""
        if self._admission is not None:
            return 0
        free = np.where(~self.active & ~self._reserved)[0]
        n = min(len(requests), len(free), self.max_prefill_batch)
        if n == 0:
            return 0
        take, slots = requests[:n], free[:n]
        bucket = 1
        while bucket < n:
            bucket *= 2
        rows = list(take) + [take[-1]] * (bucket - n)
        embeds = torch.stack([self._embeds_on_device(r.prefix_embeds) for r in rows])
        masks = np.stack([np.asarray(r.prefix_mask) for r in rows]).astype(np.int32)
        positions = np.maximum(np.cumsum(masks, axis=-1) - 1, 0).astype(np.int64)
        pmask = np.zeros((bucket, self._alloc), np.int32)
        pmask[:, :self.prefix_len] = masks
        positions_t = upload(positions, self.device)
        self._admission = {
            "take": take, "slots": slots, "n": n,
            "cache": init_cache(self.model.cfg, bucket, self._alloc, self.device),
            "embeds": embeds, "positions": positions_t, "pmask": upload(pmask, self.device),
            "last_pos": positions_t[:, -1], "hidden": None, "chunk": 0,
        }
        self._reserved[slots] = True
        return n

    @torch.inference_mode()
    def admission_step(self) -> bool:
        """Run the next admission stage: one prefill segment, or (all done)
        the epilogue — lm_head seed, compaction under ``kv_keep``, the slot
        scatter and the row state — after which the admitted rows are
        live.  Returns True when the admission completed."""
        ad = self._admission
        assert ad is not None, "no admission in flight"
        if ad["chunk"] < len(self._chunk_starts):
            self._prefill_segment(ad, *self._chunk_starts[ad["chunk"]])
            ad["chunk"] += 1
            return False
        batch_cache, first_ids = self._finish(ad)
        take, slots, n = ad["take"], ad["slots"], ad["n"]
        self._write_slots(batch_cache, upload(slots.astype(np.int64), self.device))
        self._finish_bookkeeping(take, slots, n, first_ids, ad["last_pos"])
        self._reserved[slots] = False
        self._admission = None
        return True

    def _finish_bookkeeping(self, take, slots, n, first_ids, last_pos):
        if self.spec_width > 1:
            first_ids_h = first_ids.cpu().numpy()
            last_pos_h = last_pos.cpu().numpy()
            for i, (request, slot) in enumerate(zip(take, slots)):
                slot = int(slot)
                self.valid[slot] = 0
                if self.kv_keep:
                    # the kept columns; each layer's `valid` leaf refines them
                    self.valid[slot, :self.slot_prefix] = 1
                else:
                    self.valid[slot, :self.prefix_len] = np.asarray(request.prefix_mask)
                self.positions[slot] = int(last_pos_h[i])
                self.lengths[slot] = self.slot_prefix
                self.cur_ids[slot] = int(first_ids_h[i])
        else:
            # device row state: nothing in admission waits on the device
            valid_rows = np.zeros((n, self.max_len), np.int32)
            if self.kv_keep:
                valid_rows[:, :self.slot_prefix] = 1
            else:
                for i, request in enumerate(take):
                    valid_rows[i, :self.prefix_len] = np.asarray(request.prefix_mask)
            slots_t = upload(slots.astype(np.int64), self.device)
            self.dcur[slots_t] = first_ids[:n]
            self.dpos[slots_t] = last_pos[:n]
            self.dvalid[slots_t] = upload(valid_rows, self.device)
            self.dlen[slots_t] = self.slot_prefix
        for request, slot in zip(take, slots):
            slot = int(slot)
            self.emitted[slot] = []
            self.hints[slot] = (np.asarray(request.hint_ids)
                                if request.hint_ids is not None else None)
            self.slot_request[slot] = request.request_id
            self.active[slot] = True
            if request.request_id in self._cancelled:
                # cancelled mid-admission: the slot frees at once
                self._cancelled.discard(request.request_id)
                self.active[slot] = False
                self.slot_request[slot] = None

    def cancel(self, request_id: int) -> bool:
        """Free ``request_id``'s slot now (a deadline, a disconnect): mid-
        decode (tokens of dispatches in flight are dropped at readback),
        inside an in-flight admission (freed when its epilogue lands), or
        unknown (False).  Every other slot's tokens are unchanged: rows
        never read each other's state."""
        for i in range(self.max_slots):
            if self.active[i] and self.slot_request[i] == request_id:
                self.active[i] = False
                self.slot_request[i] = None
                self.emitted[i] = []
                self.hints[i] = None
                return True
        ad = self._admission
        if ad is not None and any(r.request_id == request_id for r in ad["take"]):
            self._cancelled.add(request_id)
            return True
        return False

    @torch.inference_mode()
    def step(self) -> list[Completion]:
        """Advance every active slot by ``steps_per_dispatch`` tokens (or
        one verified draft).  At ``pipeline_depth`` 2 the tokens returned
        are those of the previous dispatch: the first call after an
        admission returns [] and completions surface one dispatch later,
        with the same tokens."""
        if not self.active.any() and not self._inflight:
            return []
        if self.spec_width > 1:
            return self._step_spec()
        return self._step_pipelined()

    def _readback(self, toks: torch.Tensor):
        """Start copying a window's tokens to the host: a pinned buffer and
        the event after the copy on CUDA, the tensor itself on the CPU."""
        if toks.device.type != "cuda":
            return toks, None
        host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
        host.copy_(toks, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _step_pipelined(self) -> list[Completion]:
        if self.active.any():
            toks = self._decode_window(upload(self.active, self.device))
            # request ids as dispatched: a slot freed and readmitted before
            # this readback must not take its ghost tokens
            self._inflight.append((self._readback(toks), self.active.copy(),
                                   list(self.slot_request)))
        completions: list[Completion] = []
        while self._inflight and (len(self._inflight) >= self.pipeline_depth
                                  or not self.active.any()):
            completions.extend(self._process_readback())
        return completions

    def _process_readback(self) -> list[Completion]:
        (host, done), snap_active, snap_req = self._inflight.pop(0)
        if done is not None:
            done.synchronize()
        toks = host.numpy()                                   # (K, max_slots)
        completions = []
        for i in np.where(snap_active)[0]:
            if not self.active[i] or self.slot_request[i] != snap_req[i]:
                continue                                      # ghost: freed or readmitted
            for k in range(toks.shape[0]):
                token = int(toks[k, i])
                self.emitted[i].append(token)
                if token == self.eos_id or len(self.emitted[i]) >= self.max_new_tokens:
                    completions.append(Completion(self.slot_request[i], self.emitted[i]))
                    self.active[i] = False
                    self.slot_request[i] = None
                    break
        if not self.active.any():
            self._inflight.clear()          # what is left in flight is ghost work
        return completions

    def _draft_for_slot(self, i: int) -> list[int]:
        """(W,) draft: the pending token plus W-1 lookup guesses, from this
        slot's emitted history first, then its prompt-lookup hint stream,
        then the pending token repeated (drafts are verified)."""
        w = self.spec_width
        cur = int(self.cur_ids[i])
        hist = self.emitted[i]
        guesses = []
        for j in range(len(hist) - 1, -1, -1):
            if hist[j] == cur:
                guesses = hist[j + 1:j + w]
                break
        if not guesses and self.hints[i] is not None:
            hints = self.hints[i]
            hits = np.where(hints[:-1] == cur)[0]
            if len(hits):
                j = int(hits[-1])
                guesses = hints[j + 1:j + w].tolist()
        draft = [cur] + list(guesses)
        draft += [cur] * (w - len(draft))
        return draft

    def _step_spec(self) -> list[Completion]:
        w = self.spec_width
        drafts = np.zeros((self.max_slots, w), np.int32)
        for i in np.where(self.active)[0]:
            drafts[i] = self._draft_for_slot(i)
        model_next = self._decode_spec(*(upload(a, self.device) for a in (
            drafts, self.positions, self.valid, self.lengths, self.active))).cpu().numpy()
        completions = []
        for i in np.where(self.active)[0]:
            budget = self.max_new_tokens - len(self.emitted[i])
            accept = 1
            while (accept < w and accept < budget
                   and drafts[i, accept] == model_next[i, accept - 1]
                   and drafts[i, accept - 1] != self.eos_id):
                accept += 1
            finished = False
            start = int(self.lengths[i])
            for k in range(accept):
                token = int(drafts[i, k])
                self.emitted[i].append(token)
                self.valid[i, min(start + k, self.max_len - 1)] = 1
                if token == self.eos_id or len(self.emitted[i]) >= self.max_new_tokens:
                    accept = k + 1
                    completions.append(Completion(self.slot_request[i], self.emitted[i]))
                    self.active[i] = False
                    self.slot_request[i] = None
                    self.valid[i] = 0
                    finished = True
                    break
            if not finished:
                self.cur_ids[i] = int(model_next[i, accept - 1])
                self.positions[i] += accept
                self.lengths[i] += accept
        return completions

    def reset(self):
        """Return the engine to an idle, empty state, keeping the slot
        cache: admission overwrites an admitted slot's cache rows and row
        state, and inactive slots are never read."""
        self._inflight.clear()
        self._admission = None
        self._cancelled.clear()
        self._reserved[:] = False
        self.valid[:] = 0
        self.positions[:] = 0
        self.lengths[:] = self.prefix_len
        self.cur_ids[:] = 0
        self.emitted = [[] for _ in range(self.max_slots)]
        self.hints = [None] * self.max_slots
        self.slot_request = [None] * self.max_slots
        self.active[:] = False

    def close(self):
        """Release the device state now — the slot cache, the row state and
        any in-flight admission.  The engine is unusable afterwards."""
        self._inflight.clear()
        self._admission = None
        for name in ("cache", "dvalid", "dpos", "dlen", "dcur", "_rows"):
            setattr(self, name, None)

    def run_to_completion(self) -> list[Completion]:
        out = []
        while self._admission is not None:
            self.admission_step()
        while self.active.any() or self._inflight:
            out.extend(self.step())
        return out
