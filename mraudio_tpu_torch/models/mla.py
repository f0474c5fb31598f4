"""DeepSeek-V3 latent attention (MLA), ``LlamaConfig.attention_kind="mla"``:
``transformers``' ``models/deepseek_v3/modeling_deepseek_v3.py::
DeepseekV3Attention`` with ``q_lora_rank`` null, as Kimi-VL-A3B's decoder
has it.  The JAX package has no such attention.

* ``q_proj`` gives each head ``qk_nope_head_dim`` + ``qk_rope_head_dim``
  query dimensions;
* ``kv_a_proj_with_mqa`` gives the ``kv_lora_rank`` latent, normalised by
  ``kv_a_layernorm`` (an RMSNorm at its default eps of 1e-6, not
  ``rms_norm_eps``), and one ``qk_rope_head_dim`` key shared by every
  head; ``kv_b_proj`` maps the latent to each head's
  ``qk_nope_head_dim`` key and ``v_head_dim`` value dimensions;
* rope on the rope dimensions only.  With ``rope_interleave`` the pairs
  are (2i, 2i + 1): the published code gathers the even dimensions before
  the odd ones and rotates the halves, so queries and keys come out in
  that order, and so does the cache;
* softmax scale ``(qk_nope_head_dim + qk_rope_head_dim) ** -0.5``; then
  ``o_proj`` over the heads' values.

The cache keeps per layer one (B, columns, kv_lora_rank +
qk_rope_head_dim) leaf, ``latent``: the normalised latent, then the roped
key, in the model dtype, written at the columns the dense cache uses (an
int ``cache_index``, or a (B,) tensor for rows at different columns).  No
per-head key or value is kept.

Two routes over it:

* a call of at most :data:`DECODE_QUERIES` queries over a cache (a decode
  pass) attends over the latent itself: ``kv_b_proj``'s key half is
  absorbed into the query (each head's nope query times its W_UK gives a
  latent-wide query, followed by its roped part), one product with the
  latent leaf gives the logits, the softmax is taken in f32, the
  probabilities weigh the latent, and the value half W_UV maps each
  head's weighted latent to its values;
* a longer call (the prefill) decompresses the columns written so far
  through ``kv_b_proj`` and runs ``ops/attention.py::chunked_attention``
  over 192-wide keys and 128-wide values.  The absorbed form would take
  (576 + 512) multiply-adds per query, key and head against the
  decompressed (192 + 128), 3.4 times as many, and the flash kernel takes
  head dims 64 and 128 only.

Both routes attend the columns ``kv_valid`` marks, causally by column (a
query's column is ``cache_index`` plus its index), which is what the
decoders' masks say; the bool ``mask`` argument is not read.  A decode
pass's products take all of its batch rows at once, so a row's bits may
follow the rows beside it (the dense decode attention keeps them apart).
"""

from __future__ import annotations

import torch
from torch import nn

from mraudio_tpu_torch.config import LlamaConfig
from mraudio_tpu_torch.device import torch_dtype
from mraudio_tpu_torch.models.layers import NEG_INF, RMSNorm, mm_f32
from mraudio_tpu_torch.models.llama import LlamaLinear, apply_rope
from mraudio_tpu_torch.ops.attention import chunked_attention

# calls of at most this many queries over a cache take the absorbed route
# (chunked_attention's one-pass tile width)
DECODE_QUERIES = 16
# kv_a_layernorm's eps: DeepseekV3RMSNorm's default, not rms_norm_eps
LATENT_NORM_EPS = 1e-6


def deinterleave(x: torch.Tensor) -> torch.Tensor:
    """(..., d) → the even dimensions, then the odd ones: the published
    code's order of the (2i, 2i + 1) rope pairs before it rotates halves."""
    return torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)


def init_latent_cache(cfg: LlamaConfig, batch: int, max_len: int, device) -> list:
    """Per-layer ``{"latent": (B, max_len, kv_lora_rank +
    qk_rope_head_dim)}`` zeros in the model dtype."""
    width = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    return [{"latent": torch.zeros((batch, max_len, width), dtype=torch_dtype(cfg.dtype),
                                   device=device)}
            for _ in range(cfg.num_layers)]


class MLAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        h, r, d = cfg.num_heads, cfg.kv_lora_rank, cfg.hidden_size
        nope, rope, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        self.q_proj = LlamaLinear(d, h * (nope + rope), cfg)
        self.kv_a_proj_with_mqa = LlamaLinear(d, r + rope, cfg)
        self.kv_a_layernorm = RMSNorm(r, LATENT_NORM_EPS)
        # read whole as W_UK and W_UV in a decode pass, so it keeps the
        # serving dtype under int8 weights, as the lm_head does
        self.kv_b_proj = LlamaLinear(r, h * (nope + vd), cfg, quantize_ok=False)
        self.o_proj = LlamaLinear(h * vd, d, cfg)
        self.heads, self.kv_heads = h, cfg.num_kv_heads

    def _rope(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        if self.cfg.rope_interleave:
            x = deinterleave(x)
        return apply_rope(x, positions, self.cfg.rope_theta)

    def forward(self, x, mask, positions, cache=None, cache_index=None, kv_valid=None,
                causal=False, obs_start=None, dropout_key=None, seq_parallel: bool = False):
        """``(output (B, S, hidden), cache)``; the arguments as
        ``LlamaAttention.forward`` takes them."""
        cfg = self.cfg
        b, s, _ = x.shape
        h, r = self.heads, cfg.kv_lora_rank
        nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        dev = x.device
        q = self.q_proj(x).view(b, s, h, nope + rope)
        q_nope, q_pe = q.split([nope, rope], dim=-1)
        q_pe = self._rope(q_pe, positions)
        ckv = self.kv_a_proj_with_mqa(x)
        latent = torch.cat([self.kv_a_layernorm(ckv[..., :r]),
                            self._rope(ckv[..., None, r:], positions)[:, :, 0]], dim=-1)

        steps = torch.arange(s, device=dev)
        per_row = cache is not None and not isinstance(cache_index, int)
        if cache is None:
            full, q_cols = latent, steps[None]
        elif per_row:
            q_cols = cache_index[:, None] + steps[None]                    # (B, S)
            cache["latent"][torch.arange(b, device=dev)[:, None], q_cols] = latent
            full = cache["latent"]
        else:
            q_cols = cache_index + steps[None]                             # (1, S)
            cache["latent"][:, cache_index:cache_index + s] = latent
            full = cache["latent"]
        if kv_valid is None:
            kv_valid = torch.ones((b, full.shape[1]), dtype=torch.int32, device=dev)
        if cache is not None and s <= DECODE_QUERIES:
            out = self._absorbed(q_nope, q_pe, full, kv_valid, q_cols)
        else:
            where = dict(q_offset=0)
            if per_row:
                where = dict(q_abs=q_cols)
            elif cache is not None:
                full, where = full[:, :cache_index + s], dict(q_offset=cache_index)
            out = self._decompressed(q_nope, q_pe, full, kv_valid[:, :full.shape[1]], where)
        return self.o_proj(out.reshape(b, s, h * cfg.v_head_dim)), cache

    def _decompressed(self, q_nope, q_pe, full, kv_valid, where: dict):
        """The prefill's route: (B, S, H, v_head_dim) values; ``where``
        gives the queries' columns to ``chunked_attention``."""
        cfg = self.cfg
        b, length, _ = full.shape
        h, r, nope, rope = self.heads, cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        kv = self.kv_b_proj(full[..., :r]).view(b, length, h, nope + cfg.v_head_dim)
        k = torch.cat([kv[..., :nope], full[:, :, None, r:].expand(b, length, h, rope)], dim=-1)
        return chunked_attention(torch.cat([q_nope, q_pe], dim=-1), k, kv[..., nope:], kv_valid,
                                 causal=True, kv_bshd=True, q_bshd=True, **where)

    def _absorbed(self, q_nope, q_pe, full, kv_valid, q_cols):
        """The decode route over the latent: (B, S, H, v_head_dim) values."""
        cfg = self.cfg
        b, s, h, nope = q_nope.shape
        r, vd = cfg.kv_lora_rank, cfg.v_head_dim
        dt = full.dtype
        # W_UK and W_UV as strided views of the kernel: each head's matrix
        # has one unit stride, which the batched product reads as it lies
        w = self.kv_b_proj.kernel.to(dt).view(r, h, nope + vd)
        w_uk = w[:, :, :nope].permute(1, 2, 0)                            # (H, nope, r)
        w_uv = w[:, :, nope:].permute(1, 0, 2)                            # (H, r, vd)
        q_lat = mm_f32(q_nope.permute(2, 0, 1, 3).reshape(h, b * s, nope).to(dt), w_uk)
        q_cat = torch.cat([q_lat.to(dt).view(h, b, s, r), q_pe.permute(2, 0, 1, 3).to(dt)], -1)
        q_cat = q_cat.permute(1, 2, 0, 3).reshape(b, s * h, -1)          # rows (query, head)
        kv_len = full.shape[1]
        scale = (nope + cfg.qk_rope_head_dim) ** -0.5
        logits = (mm_f32(q_cat, full.transpose(1, 2)) * scale).view(b, s, h, kv_len)
        cols = torch.arange(kv_len, device=full.device)
        valid = (kv_valid[:, None, :] > 0) & (cols[None, None, :] <= q_cols[:, :, None])
        probs = torch.softmax(torch.where(valid[:, :, None, :], logits, NEG_INF), dim=-1)
        o_lat = mm_f32(probs.to(dt).view(b, s * h, kv_len), full[:, :, :r])
        o_lat = o_lat.to(dt).view(b, s, h, r).permute(2, 0, 1, 3).reshape(h, b * s, r)
        out = mm_f32(o_lat, w_uv).to(dt)                                   # (H, B·S, vd)
        return out.view(h, b, s, vd).permute(1, 2, 0, 3)
