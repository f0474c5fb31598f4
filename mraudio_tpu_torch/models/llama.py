"""Llama/Vicuna decoder with embedding-level inputs and an int8 KV cache.

The main-path subset of the JAX package's decoder:

* ``inputs_embeds`` in, positions from the mask (cumsum - 1, clamped);
* int8 weight-only projections (per-output-channel f32 scale) with LoRA;
  decode-shaped calls (<= 32 rows) go through the order-preserving GEMV
  kernel when ``cfg.decode_gemv == "pallas"``;
* an int8 KV cache (per-(row, position, head) absmax, scales stored
  (B, kv_heads, KV)), written in place — the port owns its cache buffers.
  ``cache_index`` is an int (every row writes columns ``[i, i + s)``) or
  a (B,) tensor (row ``b`` writes ``[i_b, i_b + s)``: the speculative
  decoders' per-row columns, one index write per (row, column));
* SnapKV compaction (``cfg.kv_keep``): a prefill given ``obs_start``
  accumulates each layer's observation-window score into the cache's
  ``obs_score``; :func:`compact_cache` keeps each layer's top-``keep``
  columns and a per-layer ``valid`` leaf, which every later call writes
  as tokens land and multiplies into ``kv_valid`` and the mask;
* multi-token causal calls through the plain ``chunked_attention`` over
  the cache as stored (``cfg.attention_impl == "chunked"``, the default),
  or through the flash-attention kernel over the dequantized cache
  (``"pallas"``) when the queries start at column 0, i.e. a one-shot
  prefill or a segmented prefill's first segment; later segments, per-row
  calls (``q_abs``) and one-token steps over the int8 cache take
  ``chunked_attention`` as in the reference;
* f32 logits with padded vocab columns at ``finfo(f32).min``;
* the training forward (no cache, grad enabled): LoRA dropout on the
  adapter input, each projection's mask drawn from a ``torch.Generator``
  seeded by the step's ``dropout_key`` and the projection's place, so the
  recompute of a checkpointed block draws the same mask;
  ``cfg.grad_checkpoint`` recomputes each block in the backward
  (``torch.utils.checkpoint``), and ``chunked_attention`` recomputes each
  tile step.  The frozen base and the embedding never take a gradient,
  and a flash forward whose inputs need one raises: the reference has no
  backward for its kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mraudio_tpu_torch.config import LlamaConfig, LoraConfig
from mraudio_tpu_torch.device import torch_dtype
from mraudio_tpu_torch.models.layers import (DECODE_ROWS, NEG_INF, Embed, RMSNorm, _MatmulF32,
                                             _empty, mm_f32, pad_rows, top_k_indices)
from mraudio_tpu_torch.ops.attention import chunked_attention, flash_attention
from mraudio_tpu_torch.ops.gemv import decode_gemv, supports


def quantize_kv(x: torch.Tensor):
    """Per-(row, position, head) absmax int8 quantization along the last
    axis: returns (int8 values, f32 scales), x ≈ q * scale[..., None]."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    scale = torch.where(scale == 0, 1.0, scale)
    q = torch.round(xf / scale[..., None]).to(torch.int8)
    return q, scale


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D), positions (B, S).  Angles in f32, the rotation in
    ``x.dtype`` (HF ``apply_rotary_pos_emb`` semantics)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., K) @ (K, N) with f32 accumulation, f32 result.  On CUDA the
    operands stay in their dtype (``torch.mm`` with ``out_dtype``), and a
    decode-shaped call runs at one row count (``pad_rows``).  The CPU has
    no such kernel and takes the same math in f32."""
    x2 = x.reshape(-1, x.shape[-1])
    m = x2.shape[0]
    if x2.is_cuda and torch.is_grad_enabled() and (x2.requires_grad or w.requires_grad):
        y = _MatmulF32.apply(pad_rows(x2), w)[:m]
    elif x2.is_cuda:
        y = torch.mm(pad_rows(x2), w, out_dtype=torch.float32)[:m]
    else:
        y = x2.float() @ w.float()
    return y.reshape(x.shape[:-1] + (w.shape[-1],))


# the LoRA projections of a block, in the order their dropout ids count
LORA_PROJECTIONS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


def dropout_generator(key: tuple, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded by the integer tuple
    ``key``, through numpy's ``SeedSequence`` (the counterpart of JAX's
    ``fold_in``: each key gives its own stream)."""
    seed = int(np.random.SeedSequence([int(k) for k in key]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed & (2 ** 63 - 1))


def lora_dropout(x: torch.Tensor, rate: float, key: tuple) -> torch.Tensor:
    """Inverted dropout (flax ``nn.Dropout``): each element is kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``; the mask
    comes from :func:`dropout_generator` of ``key``."""
    keep_prob = 1.0 - rate
    gen = dropout_generator(key, x.device)
    keep = torch.rand(x.shape, generator=gen, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def observation_scores(q_obs, k_full, k_scale, kv_valid, q_start: int, score) -> torch.Tensor:
    """SnapKV's observation-window statistic: ``score`` (B, KV) plus, per
    cache column, the softmax mass that the queries ``q_obs`` (B, W, H, D),
    at absolute columns ``[q_start, q_start + W)``, put on it, summed over
    heads and queries.  Causal against the columns, masked by ``kv_valid``
    (B, KV), which also zeroes the rows of padding queries; K's scale
    (B, H, KV) multiplies the f32 logits.  Heads go 4 at a time (each
    softmax is per head, as in the reference), so no (B, H, W, KV) tile
    is made."""
    b, w, h, d = q_obs.shape
    kv_len = k_full.shape[1]
    dev = q_obs.device
    cols = torch.arange(kv_len, device=dev)
    ok = (cols[None, :] <= (q_start + torch.arange(w, device=dev))[:, None])[None, None]
    if kv_valid is not None:
        ok = ok & (kv_valid[:, None, None, :] > 0)
        q_valid = kv_valid[:, q_start:q_start + w].to(torch.float32)[:, None, :, None]
    hc = 4 if h % 4 == 0 else 1
    for i in range(0, h, hc):
        q_c = q_obs[:, :, i:i + hc].transpose(1, 2).reshape(b * hc, w, d)
        k_c = k_full[:, :, i:i + hc].to(q_obs.dtype).transpose(1, 2).reshape(b * hc, kv_len, d)
        logits = mm_f32(q_c, k_c.transpose(1, 2)).view(b, hc, w, kv_len) * (d ** -0.5)
        if k_scale is not None:
            logits = logits * k_scale[:, i:i + hc, None, :]
        probs = torch.softmax(torch.where(ok, logits, NEG_INF), dim=-1)
        if kv_valid is not None:
            probs = probs * q_valid
        score = score + probs.sum(dim=(1, 2))
    return score


class LlamaLinear(nn.Module):
    """Projection with optional int8 base weights and a LoRA adapter.
    ``quantize_ok=False`` keeps the lm_head in float."""

    def __init__(self, in_features: int, features: int, cfg: LlamaConfig,
                 lora: Optional[LoraConfig] = None, lora_target: bool = False,
                 quantize_ok: bool = True, use_bias: bool = False):
        super().__init__()
        if quantize_ok and cfg.quantization == "int4":
            raise NotImplementedError("int4 weights are not ported yet (ROADMAP.md A.2)")
        if quantize_ok and cfg.quantization == "int8" and cfg.int8_dot:
            raise NotImplementedError("the W8A8 int8_dot path is not ported yet (ROADMAP.md A.2)")
        self.cfg = cfg
        self.in_features, self.features = in_features, features
        self.dtype = torch_dtype(cfg.dtype)
        self.quantized = quantize_ok and cfg.quantization == "int8"
        if self.quantized:
            self.w_int8 = _empty(in_features, features, dtype=torch.int8)
            self.scale = _empty(features)
        else:
            self.kernel = _empty(in_features, features)
        self.bias = _empty(features) if use_bias else None
        self.lora_scale = 0.0
        self.lora_dropout = 0.0
        self.dropout_id: tuple = ()   # (layer, projection), set by LlamaModel
        if lora is not None and lora.enabled and lora_target:
            self.lora_a = _empty(in_features, lora.rank)
            self.lora_b = _empty(lora.rank, features)
            self.lora_scale = lora.alpha / lora.rank
            self.lora_dropout = lora.dropout

    def gemv_ok(self, x: torch.Tensor) -> bool:
        """Decode-shaped calls (<= 32 rows) take the GEMV kernel when
        configured and the dims tile."""
        return (self.cfg.decode_gemv == "pallas"
                and math.prod(x.shape[:-1]) <= DECODE_ROWS
                and supports(self.in_features, self.features))

    def forward(self, x: torch.Tensor, dropout_key: tuple | None = None) -> torch.Tensor:
        """``dropout_key``: the training step's key; LoRA dropout then
        applies to the adapter's input."""
        dt = self.dtype
        w = self.w_int8 if self.quantized else self.kernel.to(dt)
        scale = self.scale if self.quantized else None
        if self.gemv_ok(x):
            rows = x.shape[:-1]
            y = decode_gemv(x.reshape(-1, x.shape[-1]).to(dt).contiguous(), w, scale,
                            out_dtype=dt)
            y = y.reshape(rows + (self.features,))
        elif self.quantized:
            y = (matmul_f32(x.to(dt), w.to(dt)) * scale).to(dt)
        else:
            y = matmul_f32(x.to(dt), w).to(dt)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        if self.lora_scale:
            h = x
            if dropout_key is not None and self.lora_dropout > 0:
                h = lora_dropout(h, self.lora_dropout, tuple(dropout_key) + self.dropout_id)
            y = y + self.lora_delta(h.to(dt)) * self.lora_scale
        return y

    def lora_delta(self, x: torch.Tensor) -> torch.Tensor:
        """``(x @ lora_a) @ lora_b`` in ``x``'s dtype.  On CUDA a row's bits
        must not depend on the rows beside it (the speculative decoders and
        the serving engine reproduce greedy's tokens): a decode-shaped call
        runs padded to ``DECODE_ROWS`` rows, as the base projection does,
        and a longer one one batch row at a time, since the rank-r
        products' algorithm follows their row count (an engine admission of
        4 rows must give an offline prefill's bits at 3)."""
        a, b = self.lora_a.to(x.dtype), self.lora_b.to(x.dtype)
        x2 = x.reshape(-1, x.shape[-1])
        if x2.is_cuda and x2.shape[0] > DECODE_ROWS:
            rows = x.reshape(x.shape[0], -1, x.shape[-1])
            delta = torch.cat([(row @ a) @ b for row in rows])
        else:
            delta = ((pad_rows(x2) @ a) @ b)[:x2.shape[0]]
        return delta.reshape(x.shape[:-1] + (b.shape[-1],))


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, lora: Optional[LoraConfig]):
        super().__init__()
        self.cfg = cfg
        d = cfg.head_dim
        targets = lora.target_modules if lora else ()

        def lin(name, feats):
            return LlamaLinear(
                cfg.hidden_size if name != "o_proj" else cfg.num_heads * d, feats, cfg,
                lora=lora, lora_target=name in targets,
                use_bias=cfg.attention_bias and name in ("q_proj", "k_proj", "v_proj"),
            )

        self.q_proj = lin("q_proj", cfg.num_heads * d)
        self.k_proj = lin("k_proj", cfg.num_kv_heads * d)
        self.v_proj = lin("v_proj", cfg.num_kv_heads * d)
        self.o_proj = lin("o_proj", cfg.hidden_size)

    def forward(self, x, mask, positions, cache=None, cache_index=None,
                kv_valid=None, causal=False, obs_start=None, dropout_key=None):
        cfg = self.cfg
        b, s, _ = x.shape
        h, d, kv_h = cfg.num_heads, cfg.head_dim, cfg.num_kv_heads
        dt = torch_dtype(cfg.dtype)
        q = apply_rope(self.q_proj(x, dropout_key).view(b, s, h, d), positions, cfg.rope_theta)
        k = apply_rope(self.k_proj(x, dropout_key).view(b, s, kv_h, d), positions, cfg.rope_theta)
        v = self.v_proj(x, dropout_key).view(b, s, kv_h, d)

        per_row = cache is not None and not isinstance(cache_index, int)
        quantized = False
        k_scale = v_scale = None
        if cache is not None:
            quantized = "k_scale" in cache
            if per_row:
                # row b's s tokens land at columns [i_b, i_b + s), which are
                # also their causal positions; one write per (row, column)
                rows = torch.arange(b, device=x.device)[:, None]
                q_cols = cache_index[:, None] + torch.arange(s, device=x.device)[None, :]

                def write(name, val):
                    cache[name][rows, q_cols] = val.to(cache[name].dtype)

                def write_scale(name, val):     # (B, s, kv_h) into (B, kv_h, KV)
                    cache[name][rows, :, q_cols] = val
            else:
                c0, c1 = cache_index, cache_index + s

                def write(name, val):
                    cache[name][:, c0:c1] = val.to(cache[name].dtype)

                def write_scale(name, val):
                    cache[name][:, :, c0:c1] = val.transpose(1, 2)
            if quantized:
                kq, ks = quantize_kv(k)
                vq, vs = quantize_kv(v)
                write("k", kq)
                write("v", vq)
                write_scale("k_scale", ks)
                write_scale("v_scale", vs)
                k_scale, v_scale = cache["k_scale"], cache["v_scale"]
            else:
                write("k", k)
                write("v", v)
            if "valid" in cache:
                # a compacted cache: layers keep different columns, so each
                # carries its own validity; new tokens are valid everywhere
                write("valid", torch.ones((b, s), dtype=torch.int32, device=x.device))
                layer_valid = cache["valid"]
                if kv_valid is not None:
                    kv_valid = kv_valid * layer_valid
                mask = mask & (layer_valid[:, None, None, :] > 0)
            k_full, v_full = cache["k"], cache["v"]
            q_offset = 0 if per_row else cache_index
        else:
            k_full, v_full = k, v
            q_offset = 0

        if kv_h != h:
            rep = h // kv_h
            k_full = k_full.repeat_interleave(rep, dim=2)
            v_full = v_full.repeat_interleave(rep, dim=2)
            if quantized:
                k_scale = k_scale.repeat_interleave(rep, dim=1)
                v_scale = v_scale.repeat_interleave(rep, dim=1)

        if (cfg.kv_keep > 0 and cache is not None and not per_row and "valid" not in cache
                and obs_start is not None):
            # the prefill under compaction: the SnapKV statistic of the
            # queries from absolute column obs_start on, accumulated over
            # segments so that a segmented prefill scores as one shot
            prev = cache.get("obs_score")
            if prev is None:
                prev = torch.zeros((b, k_full.shape[1]), dtype=torch.float32, device=x.device)
            lo = max(obs_start - q_offset, 0)
            if lo < s:
                prev = observation_scores(q[:, lo:], k_full, k_scale, kv_valid, q_offset + lo,
                                          prev)
            cache["obs_score"] = prev

        streaming = (cfg.attention_impl in ("chunked", "pallas") and kv_valid is not None
                     and ((s > 1 and causal) or (s == 1 and quantized)))
        if streaming and (cfg.attention_impl == "chunked" or q_offset or per_row or s == 1):
            # the reference's XLA route; the flash kernel takes only
            # multi-token queries that start at column 0
            scales = dict(k_scale=k_scale, v_scale=v_scale, scales_bhs=True) if quantized else {}
            where = dict(q_abs=q_cols) if per_row else dict(q_offset=q_offset)
            out = chunked_attention(q, k_full, v_full, kv_valid, causal=True, kv_bshd=True,
                                    q_bshd=True, **where, **scales)
        elif streaming:
            if torch.is_grad_enabled() and q.requires_grad:
                raise NotImplementedError(
                    "attention_impl='pallas' has no backward: the reference's flash kernel "
                    "defines none; train with attention_impl='chunked'")
            if quantized:
                # the flash kernel takes bf16 K/V: dequantize the cache once
                k_full = k_full.to(dt) * k_scale.transpose(1, 2)[..., None].to(dt)
                v_full = v_full.to(dt) * v_scale.transpose(1, 2)[..., None].to(dt)
            out = flash_attention(q.transpose(1, 2), k_full.transpose(1, 2),
                                  v_full.transpose(1, 2), kv_valid, causal=True)
            out = out.transpose(1, 2)
        else:
            logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_full.float()) * (d ** -0.5)
            if quantized:
                logits = logits * k_scale[:, :, None, :]
            logits = torch.where(mask, logits, NEG_INF)
            probs = torch.softmax(logits, dim=-1)
            if quantized:
                probs = probs * v_scale[:, :, None, :]
            out = torch.einsum("bhqk,bkhd->bqhd", probs.to(dt), v_full.to(dt))
        out = self.o_proj(out.reshape(b, s, h * d), dropout_key)
        return out, cache


class LlamaMlp(nn.Module):
    def __init__(self, cfg: LlamaConfig, lora: Optional[LoraConfig]):
        super().__init__()
        targets = lora.target_modules if lora else ()
        hd, inter = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = LlamaLinear(hd, inter, cfg, lora, "gate_proj" in targets)
        self.up_proj = LlamaLinear(hd, inter, cfg, lora, "up_proj" in targets)
        self.down_proj = LlamaLinear(inter, hd, cfg, lora, "down_proj" in targets)

    def forward(self, x, dropout_key=None):
        return self.down_proj(F.silu(self.gate_proj(x, dropout_key)) * self.up_proj(x, dropout_key),
                              dropout_key)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, lora: Optional[LoraConfig]):
        super().__init__()
        self.input_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.attn = LlamaAttention(cfg, lora)
        self.post_attn_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = LlamaMlp(cfg, lora)

    def forward(self, x, mask, positions, cache=None, cache_index=None,
                kv_valid=None, causal=False, obs_start=None, dropout_key=None):
        h, cache = self.attn(self.input_norm(x), mask, positions, cache, cache_index,
                             kv_valid=kv_valid, causal=causal, obs_start=obs_start,
                             dropout_key=dropout_key)
        x = x + h
        return x + self.mlp(self.post_attn_norm(x), dropout_key), cache


class LlamaModel(nn.Module):
    """Decoder stack over ``inputs_embeds``.  ``mask`` is a bool
    attend-mask broadcastable to (B, heads, q_len, kv_len), read by the
    materialized attention path; the streaming paths read ``kv_valid``
    (B, KV) instead."""

    def __init__(self, cfg: LlamaConfig, lora: Optional[LoraConfig] = None):
        super().__init__()
        for flag, on in (("scan_layers", cfg.scan_layers), ("mlp_seq_chunk", cfg.mlp_seq_chunk)):
            if on:
                raise NotImplementedError(f"LlamaConfig.{flag} is not ported yet "
                                          "(ROADMAP.md A.2)")
        if cfg.kv_quant not in ("none", "int8"):
            raise NotImplementedError(f"kv_quant={cfg.kv_quant!r} is not ported yet")
        self.cfg = cfg
        self.dtype = torch_dtype(cfg.dtype)
        self.embed_tokens = Embed(cfg.padded_vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(LlamaBlock(cfg, lora) for _ in range(cfg.num_layers))
        for i, block in enumerate(self.layers):
            for j, name in enumerate(LORA_PROJECTIONS):
                parent = block.attn if hasattr(block.attn, name) else block.mlp
                getattr(parent, name).dropout_id = (i, j)
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.lm_head = LlamaLinear(cfg.hidden_size, cfg.padded_vocab_size, cfg,
                                   quantize_ok=False)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.embed_tokens(input_ids).to(self.dtype)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """f32 lm_head logits, padded vocab columns at finfo(f32).min."""
        out = self.lm_head(hidden).float()
        v = self.cfg.vocab_size
        if self.cfg.padded_vocab_size != v:
            out[..., v:] = torch.finfo(torch.float32).min
        return out

    def forward(self, inputs_embeds, mask, positions, cache=None, cache_index=None,
                return_hidden: bool = False, kv_valid=None, causal: bool = False,
                obs_start: int | None = None, dropout_key: tuple | None = None):
        """``obs_start``: under ``cfg.kv_keep``, the absolute column where
        the prefill's SnapKV observation window starts.  ``dropout_key``:
        the training step's key (LoRA dropout on); with
        ``cfg.grad_checkpoint`` and a gradient to take, each block is
        recomputed in the backward from its input."""
        x = inputs_embeds.to(self.dtype)
        remat = self.cfg.grad_checkpoint and cache is None and torch.is_grad_enabled()
        for i, block in enumerate(self.layers):
            if remat:
                x, _ = checkpoint(block, x, mask, positions, None, None, kv_valid=kv_valid,
                                  causal=causal, obs_start=obs_start, dropout_key=dropout_key,
                                  use_reentrant=False, preserve_rng_state=False)
                continue
            x, _ = block(x, mask, positions, cache[i] if cache is not None else None,
                         cache_index, kv_valid=kv_valid, causal=causal, obs_start=obs_start,
                         dropout_key=dropout_key)
        x = self.final_norm(x)
        if return_hidden:
            return x, cache
        return self.logits(x), cache


def _compact_layer(layer: dict, kv_valid, keep: int, sink: int, obs: int, prefix_len: int,
                   extra_cols: int) -> dict:
    """Top-``keep`` gather of one layer's cache columns by its prefill
    observation-window scores, in column order, followed by
    ``extra_cols`` zero columns; with a per-layer ``valid`` leaf (rows
    with fewer than ``keep`` valid columns mark the surplus invalid).  The
    first ``sink`` and the last ``obs`` prefix columns are always kept;
    invalid columns lose every tie."""
    score = layer["obs_score"][:, :prefix_len].float()
    col = torch.arange(prefix_len, device=score.device)
    score = torch.where(((col < sink) | (col >= prefix_len - obs))[None, :], 1e30, score)
    score = torch.where(kv_valid[:, :prefix_len] > 0, score, -1e30)
    idx = torch.sort(top_k_indices(score, keep), dim=-1).values

    def gather(x):                      # columns on axis 1
        ix = idx.reshape(idx.shape + (1,) * (x.ndim - 2)).expand((-1, -1) + x.shape[2:])
        g = x[:, :prefix_len].gather(1, ix)
        return F.pad(g, (0, 0) * (x.ndim - 2) + (0, extra_cols))

    def gather_scale(x):                # (B, H, S): columns last
        g = x[:, :, :prefix_len].gather(2, idx[:, None, :].expand(-1, x.shape[1], -1))
        return F.pad(g, (0, extra_cols))

    new = {name: gather(layer[name]) for name in ("k", "v")}
    for name in ("k_scale", "v_scale"):
        if name in layer:
            new[name] = gather_scale(layer[name])
    new["valid"] = gather(kv_valid.to(torch.int32))
    return new


def compaction_sizes(cfg: LlamaConfig, prefix_len: int) -> tuple:
    """``(keep, sink, obs)`` of a prefix: the budget and the protected
    regions, clamped to the prefix and the budget."""
    keep = min(cfg.kv_keep, prefix_len)
    sink = min(cfg.kv_keep_sink, keep)
    return keep, sink, min(cfg.kv_keep_obs, prefix_len, max(keep - sink, 0))


def compact_cache(cfg: LlamaConfig, cache: list, kv_valid, prefix_len: int,
                  extra_cols: int) -> list:
    """Post-prefill KV compaction (``cfg.kv_keep``, SnapKV): ``cache`` is
    the prefill cache whose layers carry ``obs_score``, ``kv_valid`` the
    (B, KV) prefix validity.  Each layer keeps its own columns.  Returns a
    fresh cache of ``keep + extra_cols`` columns per layer whose ``valid``
    leaf the attention reads."""
    keep, sink, obs = compaction_sizes(cfg, prefix_len)
    return [_compact_layer(layer, kv_valid, keep, sink, obs, prefix_len, extra_cols)
            for layer in cache]


def init_cache(cfg: LlamaConfig, batch: int, max_len: int, device="cuda",
               valid: bool = False) -> list:
    """Per-layer KV cache dicts: (B, max_len, kv_heads, D) values (int8
    plus (B, kv_heads, max_len) f32 scales with ``kv_quant="int8"``);
    ``valid`` adds the compacted cache's per-layer (B, max_len) leaf."""
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    if cfg.kv_quant == "int8":
        sshape = (batch, cfg.num_kv_heads, max_len)
        layers = [
            {
                "k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
                "v_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
            }
            for _ in range(cfg.num_layers)
        ]
    elif cfg.kv_quant != "none":
        raise NotImplementedError(f"kv_quant={cfg.kv_quant!r} is not ported yet")
    else:
        dt = torch_dtype(cfg.dtype)
        layers = [
            {"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
            for _ in range(cfg.num_layers)
        ]
    if valid:
        for layer in layers:
            layer["valid"] = torch.zeros((batch, max_len), dtype=torch.int32, device=device)
    return layers
