"""Llama/Vicuna decoder with embedding-level inputs and a quantized KV
cache.

The JAX package's decoder:

* ``inputs_embeds`` in, positions from the mask (cumsum - 1, clamped);
* base weights in float, int8 weight-only (per-output-channel f32
  scale) or group-wise int4 (``w_int4`` nibble pairs, one f32 scale per
  group and output), each with a LoRA adapter.  Decode-shaped int8 or
  float calls (<= 32 rows) go through the order-preserving GEMV kernel
  when ``cfg.decode_gemv == "pallas"``; ``cfg.int8_dot`` (W8A8) takes
  precedence over it and quantizes the activations per row for an exact
  int8 x int8 → int32 product; int4 never reaches the GEMV (the JAX
  package's int4 branch has no kernel route);
* an int8 or int4 KV cache (per-(row, position, head) absmax, scales
  stored (B, kv_heads, KV); int4 packs two values per byte along
  head_dim, ``ops/attention.py::pack_int4``), written in place — the
  port owns its cache buffers.  ``cache_index`` is an int (every row
  writes columns ``[i, i + s)``) or a (B,) tensor (row ``b`` writes
  ``[i_b, i_b + s)``: the speculative decoders' per-row columns, one
  index write per (row, column));
* SnapKV compaction (``cfg.kv_keep``): a prefill given ``obs_start``
  accumulates each layer's observation-window score into the cache's
  ``obs_score``; :func:`compact_cache` keeps each layer's top-``keep``
  columns and a per-layer ``valid`` leaf, which every later call writes
  as tokens land and multiplies into ``kv_valid`` and the mask;
* multi-token causal calls through the plain ``chunked_attention`` over
  the cache as stored (``cfg.attention_impl == "chunked"``, the default;
  an int4 cache is unpacked tile by tile), or through the flash-attention
  kernel over the dequantized cache (``"pallas"``) when the queries start
  at column 0, i.e. a one-shot prefill or a segmented prefill's first
  segment; later segments, per-row calls (``q_abs``) and one-token steps
  over the quantized cache take ``chunked_attention`` as in the
  reference;
* ``cfg.mlp_seq_chunk`` tiles the MLP's token axis (each tile
  recomputed in the backward), parameters unchanged;
* ``cfg.scan_layers`` is a parameter layout, not a loop: the modules and
  the per-layer cache list stay as they are, and the flat parameter
  names at every boundary (``models/convert_jax.py``, the param store,
  the trainer's checkpoints) become ``llm/layers/...`` leaves with a
  leading (num_layers,) axis, the JAX package's ``nn.scan`` layout;
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

import contextlib
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
from mraudio_tpu_torch.ops.attention import (chunked_attention, flash_attention, int4_planes,
                                             pack_int4, unpack_int4)
from mraudio_tpu_torch.ops.gemv import decode_gemv, supports
from mraudio_tpu_torch.parallel import comm
from mraudio_tpu_torch.utils.profiling import annotate


def quantize_kv(x: torch.Tensor):
    """Per-(row, position, head) absmax int8 quantization along the last
    axis: returns (int8 values, f32 scales), x ≈ q * scale[..., None]."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    scale = torch.where(scale == 0, 1.0, scale)
    q = torch.round(xf / scale[..., None]).to(torch.int8)
    return q, scale


def quantize_kv4(x: torch.Tensor):
    """Per-(row, position, head) absmax int4 quantization, packed two
    values per byte along the last axis (:func:`pack_int4`): returns
    (uint8 (..., D/2), f32 scales), x ≈ unpack_int4(q) * scale[..., None].
    Values clip to ±7 (15 levels; -8 is never written), scale absmax / 7."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 7.0
    scale = torch.where(scale == 0, 1.0, scale)
    q = torch.clamp(torch.round(xf / scale[..., None]), -7, 7).to(torch.int8)
    return pack_int4(q), scale


def int_matmul(xq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 → int32, exact: on CUDA through
    ``torch._int_mm`` (K and N multiples of 8; rows padded to
    :data:`DECODE_ROWS`, as it takes more than 16), on the CPU as an int32
    product."""
    if not xq.is_cuda:
        return xq.to(torch.int32) @ w.to(torch.int32)
    return torch._int_mm(pad_rows(xq), w)[:xq.shape[0]]


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


def lora_dropout(x: torch.Tensor, rate: float, key: tuple,
                 part: tuple | None = None) -> torch.Tensor:
    """Inverted dropout (flax ``nn.Dropout``): each element is kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``; the mask
    comes from :func:`dropout_generator` of ``key``.  ``part`` ``(data
    index, data ranks, first feature, features)``: ``x`` is a data rank's
    rows of the global batch and (row-parallel) a model rank's features,
    and takes that part of the whole input's mask, so a mesh drops what
    one device drops."""
    keep_prob = 1.0 - rate
    gen = dropout_generator(key, x.device)
    if part is None:
        keep = torch.rand(x.shape, generator=gen, device=x.device) < keep_prob
    else:
        d, data, c0, width = part
        b = x.shape[0]
        keep = torch.rand((b * data,) + x.shape[1:-1] + (width,), generator=gen,
                          device=x.device) < keep_prob
        keep = keep[d * b:(d + 1) * b, ..., c0:c0 + x.shape[-1]]
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def observation_scores(q_obs, k_full, k_scale, kv_valid, q_start: int, score) -> torch.Tensor:
    """SnapKV's observation-window statistic: ``score`` (B, KV) plus, per
    cache column, the softmax mass that the queries ``q_obs`` (B, W, H, D),
    at absolute columns ``[q_start, q_start + W)``, put on it, summed over
    heads and queries.  Causal against the columns, masked by ``kv_valid``
    (B, KV), which also zeroes the rows of padding queries; K's scale
    (B, H, KV) multiplies the f32 logits.  Heads go 4 at a time (each
    softmax is per head, as in the reference), so no (B, H, W, KV) tile
    is made; an int4 cache (uint8 ``k_full``) is unpacked per head group.
    On CUDA the batch rows go one at a time: the card groups a product's
    and a reduction's terms by their batch and row counts, and a row's
    score must not follow the rows beside it (the serving engine's
    admission batch against the offline decoder's, under compaction)."""
    if q_obs.is_cuda and q_obs.shape[0] > 1:
        return torch.cat([_observation_scores(
            q_obs[i:i + 1], k_full[i:i + 1], None if k_scale is None else k_scale[i:i + 1],
            None if kv_valid is None else kv_valid[i:i + 1], q_start, score[i:i + 1])
            for i in range(q_obs.shape[0])])
    return _observation_scores(q_obs, k_full, k_scale, kv_valid, q_start, score)


def _observation_scores(q_obs, k_full, k_scale, kv_valid, q_start: int, score) -> torch.Tensor:
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
        k_c = k_full[:, :, i:i + hc]
        if k_c.dtype == torch.uint8:
            k_c = unpack_int4(k_c)
        k_c = k_c.to(q_obs.dtype).transpose(1, 2).reshape(b * hc, kv_len, d)
        logits = mm_f32(q_c, k_c.transpose(1, 2)).view(b, hc, w, kv_len) * (d ** -0.5)
        if k_scale is not None:
            logits = logits * k_scale[:, i:i + hc, None, :]
        probs = torch.softmax(torch.where(ok, logits, NEG_INF), dim=-1)
        if kv_valid is not None:
            probs = probs * q_valid
        score = score + probs.sum(dim=(1, 2))
    return score


class LlamaLinear(nn.Module):
    """Projection with float, int8 or int4 base weights and a LoRA
    adapter.  ``quantize_ok=False`` keeps the lm_head in float.

    Under tensor parallelism (``parallel/partition.py::shard_module_``)
    the parameters are this rank's shards and ``tp_mode`` says which: a
    ``"column"`` projection computes its own output features as it
    would any other; a ``"row"`` projection returns the f32 partial sum
    of its input features — base product (with its scale) plus LoRA
    delta — which the block adds across the ranks (``parallel/comm.py``)
    and rounds.  ``in_features``/``features`` stay the whole widths,
    which the GEMV route is decided on, as the JAX package decides it."""

    def __init__(self, in_features: int, features: int, cfg: LlamaConfig,
                 lora: Optional[LoraConfig] = None, lora_target: bool = False,
                 quantize_ok: bool = True, use_bias: bool = False):
        super().__init__()
        self.cfg = cfg
        self.in_features, self.features = in_features, features
        self.tp_mode: str | None = None
        self.tp_group = None
        # on a mesh: (data index, data ranks, first input feature, input
        # features), the part of a whole batch's dropout mask this rank draws
        self.dropout_part: tuple | None = None
        self.dtype = torch_dtype(cfg.dtype)
        self.quantized = quantize_ok and cfg.quantization == "int8"
        self.int4 = quantize_ok and cfg.quantization == "int4"
        if self.quantized:
            self.w_int8 = _empty(in_features, features, dtype=torch.int8)
            self.scale = _empty(features)
        elif self.int4:
            g = cfg.int4_group_size
            if in_features % g:
                raise ValueError(f"int4_group_size={g} must divide in_features={in_features}")
            self.w_int4 = _empty(in_features // g, g // 2, features, dtype=torch.uint8)
            self.w_int4_scale = _empty(in_features // g, features)
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

    @property
    def weight(self) -> torch.Tensor:
        """The stored base weight (this rank's shard under TP)."""
        if self.quantized:
            return self.w_int8
        return self.w_int4 if self.int4 else self.kernel

    def local_dims(self) -> tuple[int, int]:
        """(input, output) features this rank computes."""
        w = self.weight
        if self.int4:
            return w.shape[0] * self.cfg.int4_group_size, w.shape[-1]
        return w.shape[0], w.shape[-1]

    def gemv_ok(self, x: torch.Tensor) -> bool:
        """Decode-shaped calls (<= 32 rows) take the GEMV kernel when
        configured and the whole dims tile; int4 weights and ``int8_dot``
        never do (the reference routes neither to its kernel)."""
        return (self.cfg.decode_gemv == "pallas" and not self.int4
                and not (self.quantized and self.cfg.int8_dot)
                and math.prod(x.shape[:-1]) <= DECODE_ROWS
                and supports(self.in_features, self.features))

    def _int8_dot(self, x: torch.Tensor, group=None) -> torch.Tensor:
        """W8A8: per-row absmax int8 activations (round half to even), an
        exact int8 x int8 → int32 product, then ``acc * (x_scale *
        scale)`` in f32 — the reference's order.  Row-parallel (``group``)
        the absmax is taken over the whole row, across the ranks."""
        xf = x.float()
        x_scale = comm.all_reduce_max(xf.abs().amax(dim=-1, keepdim=True), group) / 127.0
        x_scale = torch.where(x_scale == 0, 1.0, x_scale)
        x_q = torch.round(xf / x_scale).to(torch.int8)
        acc = int_matmul(x_q.reshape(-1, x.shape[-1]), self.w_int8)
        acc = acc.reshape(x.shape[:-1] + (acc.shape[-1],))
        return acc.float() * (x_scale * self.scale)

    def _int4_matmul(self, x: torch.Tensor) -> torch.Tensor:
        """Group-wise int4: each nibble plane (group elements ``[0, g/2)``
        and ``[g/2, g)``) contracts against its half of every activation
        group.  Over 16 tokens the scales fold into each plane's operand
        and two (M, in/2) x (in/2, out) products follow; at 16 tokens or
        fewer, per-group partial sums take ``* scale`` before the group
        sum.  Operands in the model dtype on CUDA (the reference's TPU
        route; decode rows padded to :data:`DECODE_ROWS`), f32 on the CPU
        (its CPU route).  Returns the f32 sums."""
        g = self.cfg.int4_group_size
        in_f, out_f = self.local_dims()
        ng, half = in_f // g, g // 2
        lo, hi = int4_planes(self.w_int4)                  # (groups, g/2, out) int8
        scale = self.w_int4_scale                          # (groups, out) f32
        op = self.dtype if x.is_cuda else torch.float32
        x2 = x.reshape(-1, in_f).to(op)
        m = x2.shape[0]
        xg = x2.view(m, ng, g)
        xa, xb = xg[..., :half], xg[..., half:]
        if m > 16:
            lo_w = (lo * scale[:, None, :]).to(op).reshape(ng * half, out_f)
            hi_w = (hi * scale[:, None, :]).to(op).reshape(ng * half, out_f)
            y = (matmul_f32(xa.reshape(m, ng * half), lo_w)
                 + matmul_f32(xb.reshape(m, ng * half), hi_w))
        else:
            def groups_major(t):                            # (M, groups, g/2) → (groups, M', g/2)
                t = t.transpose(0, 1)
                if t.is_cuda and m < DECODE_ROWS:
                    t = F.pad(t, (0, 0, 0, DECODE_ROWS - m))
                return t.contiguous()

            acc = mm_f32(groups_major(xa), lo.to(op)) + mm_f32(groups_major(xb), hi.to(op))
            y = (acc * scale[:, None, :]).sum(dim=0)[:m]
        return y.reshape(x.shape[:-1] + (out_f,))

    def _base(self, x: torch.Tensor) -> torch.Tensor:
        """The base product as f32 values before the rounding to the
        model dtype (the GEMV kernel's output is rounded already)."""
        dt = self.dtype
        if self.quantized and self.cfg.int8_dot:
            return self._int8_dot(x, self.tp_group if self.tp_mode == "row" else None)
        if self.int4:
            return self._int4_matmul(x)
        if self.gemv_ok(x):
            w = self.w_int8 if self.quantized else self.kernel.to(dt)
            y = decode_gemv(x.reshape(-1, x.shape[-1]).to(dt).contiguous(), w,
                            self.scale if self.quantized else None, out_dtype=dt)
            return y.reshape(x.shape[:-1] + (w.shape[-1],)).float()
        if self.quantized:
            return matmul_f32(x.to(dt), self.w_int8.to(dt)) * self.scale
        return matmul_f32(x.to(dt), self.kernel.to(dt))

    def forward(self, x: torch.Tensor, dropout_key: tuple | None = None) -> torch.Tensor:
        """``dropout_key``: the training step's key; LoRA dropout then
        applies to the adapter's input.  A row-parallel projection
        returns its f32 partial sum."""
        dt = self.dtype
        y = self._base(x)
        if self.tp_mode != "row":
            y = y.to(dt)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        if self.lora_scale:
            h = x
            if dropout_key is not None and self.lora_dropout > 0:
                h = lora_dropout(h, self.lora_dropout, tuple(dropout_key) + self.dropout_id,
                                 self.dropout_part)
            delta = self.lora_delta(h.to(dt)) * self.lora_scale
            y = y + (delta.float() if self.tp_mode == "row" else delta)
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
        # this rank's heads (all of them without tensor parallelism)
        self.heads, self.kv_heads = cfg.num_heads, cfg.num_kv_heads
        self.tp_group = None

    def forward(self, x, mask, positions, cache=None, cache_index=None,
                kv_valid=None, causal=False, obs_start=None, dropout_key=None,
                seq_parallel: bool = False):
        """``seq_parallel``: ``x`` is this rank's chunk of the sequence
        (``LlamaConfig.seq_shard``), gathered here and the output
        reduce-scattered back; otherwise, under tensor parallelism, the
        output's partial sums are added across the ranks."""
        cfg = self.cfg
        group = self.tp_group
        x = (comm.gather_seq(x, group, positions.shape[1]) if seq_parallel
             else comm.enter_tp(x, group))
        b, s, _ = x.shape
        h, d, kv_h = self.heads, cfg.head_dim, self.kv_heads
        dt = torch_dtype(cfg.dtype)
        q = apply_rope(self.q_proj(x, dropout_key).view(b, s, h, d), positions, cfg.rope_theta)
        k = apply_rope(self.k_proj(x, dropout_key).view(b, s, kv_h, d), positions, cfg.rope_theta)
        v = self.v_proj(x, dropout_key).view(b, s, kv_h, d)

        per_row = cache is not None and not isinstance(cache_index, int)
        quantized = packed = False
        k_scale = v_scale = None
        if cache is not None:
            quantized = "k_scale" in cache
            # int4: uint8 nibble pairs (B, KV, kv_h, D/2), unpacked where read
            packed = quantized and cache["k"].dtype == torch.uint8
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
                quantize = quantize_kv4 if packed else quantize_kv
                kq, ks = quantize(k)
                vq, vs = quantize(v)
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
            if lo < s and group is None:
                prev = observation_scores(q[:, lo:], k_full, k_scale, kv_valid, q_offset + lo,
                                          prev)
            elif lo < s:
                # this rank's heads' sums, added across the ranks in one
                # order: every rank keeps the same columns
                part = observation_scores(q[:, lo:], k_full, k_scale, kv_valid, q_offset + lo,
                                          torch.zeros_like(prev))
                prev = prev + comm.ordered_sum(part, group)
            cache["obs_score"] = prev

        streaming = (cfg.attention_impl in ("chunked", "pallas") and kv_valid is not None
                     and ((s > 1 and causal) or (s == 1 and quantized)))
        if streaming and (cfg.attention_impl == "chunked" or q_offset or per_row or s == 1):
            # the reference's XLA route; the flash kernel takes only
            # multi-token queries that start at column 0
            scales = (dict(k_scale=k_scale, v_scale=v_scale, scales_bhs=True, kv_packed=packed)
                      if quantized else {})
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
                if packed:
                    k_full, v_full = unpack_int4(k_full), unpack_int4(v_full)
                k_full = k_full.to(dt) * k_scale.transpose(1, 2)[..., None].to(dt)
                v_full = v_full.to(dt) * v_scale.transpose(1, 2)[..., None].to(dt)
            out = flash_attention(q.transpose(1, 2), k_full.transpose(1, 2),
                                  v_full.transpose(1, 2), kv_valid, causal=True)
            out = out.transpose(1, 2)
        else:
            if packed:
                k_full, v_full = unpack_int4(k_full), unpack_int4(v_full)
            logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_full.float()) * (d ** -0.5)
            if quantized:
                logits = logits * k_scale[:, :, None, :]
            logits = torch.where(mask, logits, NEG_INF)
            probs = torch.softmax(logits, dim=-1)
            if quantized:
                probs = probs * v_scale[:, :, None, :]
            out = torch.einsum("bhqk,bkhd->bqhd", probs.to(dt), v_full.to(dt))
        out = self.o_proj(out.reshape(b, s, h * d), dropout_key)
        return _tp_exit(out, group, seq_parallel, dt), cache


def _tp_exit(partial, group, seq_parallel: bool, dtype):
    """A row-parallel projection's f32 partial sums → the block output in
    ``dtype``: reduce-scattered along S under sequence parallelism, added
    across the model ranks otherwise; without a model axis the output as
    it is."""
    if group is None:
        return partial
    if seq_parallel:
        return comm.scatter_seq(partial, group).to(dtype)
    return comm.row_reduce(partial, group).to(dtype)


class LlamaMlp(nn.Module):
    def __init__(self, cfg: LlamaConfig, lora: Optional[LoraConfig]):
        super().__init__()
        self.cfg = cfg
        targets = lora.target_modules if lora else ()
        hd, inter = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = LlamaLinear(hd, inter, cfg, lora, "gate_proj" in targets)
        self.up_proj = LlamaLinear(hd, inter, cfg, lora, "up_proj" in targets)
        self.down_proj = LlamaLinear(inter, hd, cfg, lora, "down_proj" in targets)
        self.tp_group = None

    def _core(self, x, dropout_key=None):
        return self.down_proj(F.silu(self.gate_proj(x, dropout_key)) * self.up_proj(x, dropout_key),
                              dropout_key)

    def forward(self, x, dropout_key=None, seq_parallel: bool = False, seq_len: int = 0):
        """With ``cfg.mlp_seq_chunk`` and more tokens than it, the token
        axis goes in tiles of that many (the last zero-padded), each
        recomputed in the backward when a gradient is taken, so only one
        tile's (B, chunk, intermediate) temporaries live at a time.  Tile
        ``t``'s LoRA dropout key gains ``t``.  ``seq_parallel``: ``x`` is
        this rank's chunk of a ``seq_len``-long sequence, as
        :meth:`LlamaAttention.forward` takes it."""
        group = self.tp_group
        x = comm.gather_seq(x, group, seq_len) if seq_parallel else comm.enter_tp(x, group)
        return _tp_exit(self._tiles(x, dropout_key), group, seq_parallel,
                        torch_dtype(self.cfg.dtype))

    def _tiles(self, x, dropout_key):
        chunk = self.cfg.mlp_seq_chunk
        s = x.shape[1]
        if not chunk or s <= chunk:
            return self._core(x, dropout_key)
        pad = (-s) % chunk
        xp = F.pad(x, (0, 0, 0, pad)) if pad else x
        remat = torch.is_grad_enabled()
        tiles = []
        for t, i in enumerate(range(0, s + pad, chunk)):
            key = None if dropout_key is None else tuple(dropout_key) + (t,)
            if remat:
                tiles.append(checkpoint(self._core, xp[:, i:i + chunk], key,
                                        use_reentrant=False, preserve_rng_state=False))
            else:
                tiles.append(self._core(xp[:, i:i + chunk], key))
        return torch.cat(tiles, dim=1)[:, :s]


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, lora: Optional[LoraConfig]):
        super().__init__()
        self.input_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.attn = LlamaAttention(cfg, lora)
        self.post_attn_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = LlamaMlp(cfg, lora)

    def forward(self, x, mask, positions, cache=None, cache_index=None,
                kv_valid=None, causal=False, obs_start=None, dropout_key=None,
                seq_parallel: bool = False):
        h, cache = self.attn(self.input_norm(x), mask, positions, cache, cache_index,
                             kv_valid=kv_valid, causal=causal, obs_start=obs_start,
                             dropout_key=dropout_key, seq_parallel=seq_parallel)
        x = x + h
        return x + self.mlp(self.post_attn_norm(x), dropout_key, seq_parallel,
                            positions.shape[1]), cache


class ExpertBlock(nn.Module):
    """A DeepSeek-V3 decoder layer (``attention_kind="mla"`` or routed
    experts): pre-norm attention, latent (``models/mla.py``) or grouped-
    query, then the expert layer (``models/moe.py``) or, below
    ``first_k_dense_replace``, the dense MLP.  The latent attention and the
    expert layer each run inside a profiler span named for the call:
    ``mla.decode`` and ``moe.decode`` in a call of at most 16 queries over
    a cache (a decode pass), ``mla.prefill`` and ``moe.prefill`` in any
    other."""

    def __init__(self, cfg: LlamaConfig, lora: Optional[LoraConfig], layer: int):
        from mraudio_tpu_torch.models.mla import DECODE_QUERIES, MLAttention
        from mraudio_tpu_torch.models.moe import MoeMlp

        super().__init__()
        self.decode_queries = DECODE_QUERIES
        self.latent = cfg.attention_kind == "mla"
        self.moe = cfg.moe_layer(layer)
        self.input_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.attn = MLAttention(cfg) if self.latent else LlamaAttention(cfg, lora)
        self.post_attn_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = MoeMlp(cfg) if self.moe else LlamaMlp(cfg, lora)

    def forward(self, x, mask, positions, cache=None, cache_index=None,
                kv_valid=None, causal=False, obs_start=None, dropout_key=None,
                seq_parallel: bool = False):
        phase = ("decode" if cache is not None and x.shape[1] <= self.decode_queries
                 else "prefill")
        h = self.input_norm(x)
        with annotate(f"mla.{phase}") if self.latent else contextlib.nullcontext():
            h, cache = self.attn(h, mask, positions, cache, cache_index, kv_valid=kv_valid,
                                 causal=causal, obs_start=obs_start, dropout_key=dropout_key,
                                 seq_parallel=seq_parallel)
        x = x + h
        h = self.post_attn_norm(x)
        if self.moe:
            with annotate(f"moe.{phase}"):
                return x + self.mlp(h, decode=phase == "decode"), cache
        return x + self.mlp(h, dropout_key, seq_parallel, positions.shape[1]), cache


def refuse_unsupported(cfg: LlamaConfig, lora: Optional[LoraConfig] = None) -> None:
    """Raise, naming the field, for a setting that the latent attention or
    the expert layer does not support, rather than ignore it; a dense
    grouped-query decoder passes whatever its other fields say."""
    if cfg.attention_kind not in ("gqa", "mla"):
        raise ValueError(f"unknown attention_kind={cfg.attention_kind!r}")
    latent, moe = cfg.attention_kind == "mla", cfg.n_routed_experts > 0
    if cfg.rope_interleave and not latent:
        raise NotImplementedError("rope_interleave is read by attention_kind='mla' only")
    if latent and (min(cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.v_head_dim) <= 0
                   or cfg.qk_rope_head_dim <= 0 or cfg.qk_rope_head_dim % 2):
        raise ValueError("attention_kind='mla' needs kv_lora_rank, qk_nope_head_dim, "
                         "v_head_dim and an even qk_rope_head_dim above 0")
    if moe and not (0 < cfg.num_experts_per_tok <= cfg.n_routed_experts
                    and cfg.moe_intermediate_size > 0):
        raise ValueError("n_routed_experts needs 0 < num_experts_per_tok <= n_routed_experts "
                         "and moe_intermediate_size above 0")
    refused = {
        "kv_quant": latent and cfg.kv_quant != "none",
        "kv_keep": latent and cfg.kv_keep > 0,
        "attention_impl": latent and cfg.attention_impl != "chunked",
        "mlp_seq_chunk": moe and cfg.mlp_seq_chunk > 0,
        "quantization": (moe and cfg.quantization != "none")
                        or (latent and cfg.quantization == "int4"),
        "seq_shard": (latent or moe) and cfg.seq_shard,
        "scan_layers": (latent or moe) and cfg.scan_layers,
        "lora.enabled": (latent or moe) and lora is not None and lora.enabled,
    }
    for name, bad in refused.items():
        if bad:
            raise NotImplementedError(
                f"{name} is not supported with attention_kind={cfg.attention_kind!r} and "
                f"n_routed_experts={cfg.n_routed_experts}")


class LlamaModel(nn.Module):
    """Decoder stack over ``inputs_embeds``.  ``mask`` is a bool
    attend-mask broadcastable to (B, heads, q_len, kv_len), read by the
    materialized attention path; the streaming paths read ``kv_valid``
    (B, KV) instead."""

    def __init__(self, cfg: LlamaConfig, lora: Optional[LoraConfig] = None):
        super().__init__()
        if cfg.kv_quant not in ("none", "int8", "int4"):
            raise ValueError(f"unknown kv_quant={cfg.kv_quant!r}")
        refuse_unsupported(cfg, lora)
        self.cfg = cfg
        self.dtype = torch_dtype(cfg.dtype)
        self.embed_tokens = Embed(cfg.padded_vocab_size, cfg.hidden_size)
        if cfg.attention_kind == "mla" or cfg.n_routed_experts:
            self.layers = nn.ModuleList(ExpertBlock(cfg, lora, i) for i in range(cfg.num_layers))
        else:
            self.layers = nn.ModuleList(LlamaBlock(cfg, lora) for _ in range(cfg.num_layers))
        for i, block in enumerate(self.layers):
            for j, name in enumerate(LORA_PROJECTIONS):
                parent = block.attn if hasattr(block.attn, name) else block.mlp
                if hasattr(parent, name):
                    getattr(parent, name).dropout_id = (i, j)
        # the expert layers' routing counters of the current batch
        # (models/moe.py), read by infer/generate.py; None when dense
        self.expert_counters = None
        # greedy decode replays a CUDA graph of one pass (infer/generate.py)
        self.decode_graph = cfg.attention_kind == "mla"
        if cfg.n_routed_experts:
            from mraudio_tpu_torch.models.moe import ExpertCounters

            self.expert_counters = ExpertCounters()
            for block in self.layers:
                if block.moe:
                    block.mlp.counters = self.expert_counters
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.lm_head = LlamaLinear(cfg.hidden_size, cfg.padded_vocab_size, cfg,
                                   quantize_ok=False)
        # tensor parallelism (parallel/partition.py::shard_module_): the
        # model group, and whether the embedding's and the lm_head's
        # vocabularies are sharded over it
        self.tp_group = None
        self.vocab_sharded = False

    @property
    def cache_cfg(self) -> LlamaConfig:
        """The config :func:`init_cache` sizes this rank's cache by: its
        own KV heads under tensor parallelism."""
        kv = self.layers[0].attn.kv_heads if len(self.layers) else self.cfg.num_kv_heads
        return self.cfg if kv == self.cfg.num_kv_heads else self.cfg.replace(num_kv_heads=kv)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        if self.vocab_sharded:
            return comm.vocab_embed(input_ids, self.embed_tokens.embedding,
                                    self.tp_group).to(self.dtype)
        return self.embed_tokens(input_ids).to(self.dtype)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """f32 lm_head logits, padded vocab columns at finfo(f32).min.
        A vocab-sharded lm_head computes this rank's columns, and the
        whole rows are gathered."""
        sharded = self.lm_head.tp_mode == "column"
        if sharded:
            hidden = comm.enter_tp(hidden, self.tp_group)
        out = self.lm_head(hidden).float()
        lo = comm.group_rank(self.tp_group) * out.shape[-1] if sharded else 0
        v = self.cfg.vocab_size - lo
        if v < out.shape[-1]:
            out[..., max(v, 0):] = torch.finfo(torch.float32).min
        return comm.gather_last(out, self.tp_group) if sharded else out

    def seq_parallel(self, s: int) -> bool:
        """Whether a call over ``s`` tokens splits the residual stream
        along S (``cfg.seq_shard`` on a model axis, at least 2 tokens per
        rank, as the JAX package's ``seq_shard``)."""
        if not (self.cfg.seq_shard and self.tp_group is not None):
            return False
        return s >= 2 * comm.group_size(self.tp_group)

    def forward(self, inputs_embeds, mask, positions, cache=None, cache_index=None,
                return_hidden: bool = False, kv_valid=None, causal: bool = False,
                obs_start: int | None = None, dropout_key: tuple | None = None):
        """``obs_start``: under ``cfg.kv_keep``, the absolute column where
        the prefill's SnapKV observation window starts.  ``dropout_key``:
        the training step's key (LoRA dropout on); with
        ``cfg.grad_checkpoint`` and a gradient to take, each block is
        recomputed in the backward from its input."""
        x = inputs_embeds.to(self.dtype)
        s = x.shape[1]
        sp = self.seq_parallel(s)
        if sp:
            x = comm.split_seq(x, self.tp_group)
        remat = self.cfg.grad_checkpoint and cache is None and torch.is_grad_enabled()
        for i, block in enumerate(self.layers):
            if remat:
                x, _ = checkpoint(block, x, mask, positions, None, None, kv_valid=kv_valid,
                                  causal=causal, obs_start=obs_start, dropout_key=dropout_key,
                                  seq_parallel=sp, use_reentrant=False, preserve_rng_state=False)
                continue
            x, _ = block(x, mask, positions, cache[i] if cache is not None else None,
                         cache_index, kv_valid=kv_valid, causal=causal, obs_start=obs_start,
                         dropout_key=dropout_key, seq_parallel=sp)
        x = self.final_norm(x)
        if sp:
            x = comm.gather_seq_replicated(x, self.tp_group, s)
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
    plus (B, kv_heads, max_len) f32 scales with ``kv_quant="int8"``; uint8
    nibble pairs (B, max_len, kv_heads, D/2) and the same scales with
    ``"int4"``); ``valid`` adds the compacted cache's per-layer
    (B, max_len) leaf.  A list under ``cfg.scan_layers`` too: the JAX
    package's stacked cache is its ``nn.scan`` plumbing.  The int4 leaves
    keep their (kv_heads, D/2) axes, which the JAX package merges into one
    only to spare a TPU lane tile its padding.  A tensor-parallel rank
    passes ``LlamaModel.cache_cfg``, which counts its own KV heads.  Latent
    attention keeps its own layout (``models/mla.py``)."""
    if cfg.attention_kind == "mla":
        from mraudio_tpu_torch.models.mla import init_latent_cache

        return init_latent_cache(cfg, batch, max_len, device)
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    if cfg.kv_quant in ("int8", "int4"):
        qdtype = torch.int8
        if cfg.kv_quant == "int4":
            if cfg.head_dim % 2:
                raise ValueError("kv_quant='int4' needs an even head_dim")
            shape, qdtype = shape[:-1] + (cfg.head_dim // 2,), torch.uint8
        sshape = (batch, cfg.num_kv_heads, max_len)
        layers = [
            {
                "k": torch.zeros(shape, dtype=qdtype, device=device),
                "v": torch.zeros(shape, dtype=qdtype, device=device),
                "k_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
                "v_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
            }
            for _ in range(cfg.num_layers)
        ]
    elif cfg.kv_quant != "none":
        raise ValueError(f"unknown kv_quant={cfg.kv_quant!r}")
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
