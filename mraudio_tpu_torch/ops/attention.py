"""Attention ops for the decoder: the flash-attention prefill kernel with
its plain version, and the plain ``chunked_attention``.

``flash_attention`` replaces the TPU kernel
``mraudio_tpu/ops/attention.py::flash_attention`` (``_flash_kernel``).
On CUDA tensors it launches ``csrc/flash_attention.cu`` (bound by
tensor-core operations at the prefill shape; TMA-fed K/V ring, both
products on wgmma, f32 online softmax in registers, see the source); on
CPU tensors it runs :func:`flash_attention_plain`, which computes the
same function.

``chunked_attention`` is the reference's XLA online-softmax attention
(``mraudio_tpu/ops/attention.py::chunked_attention``), plain PyTorch
here too: the multi-token route of the default configuration
(``attention_impl="chunked"``), every prefill segment after the first,
every one-token decode step over the int8 cache and every speculative
pass (per-row columns, ``q_abs``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from mraudio_tpu_torch.models.layers import NEG_INF
from mraudio_tpu_torch.ops import build


def flash_attention_plain(q, k, v, mask, causal: bool = True,
                          q_chunk: int = 1024) -> torch.Tensor:
    """Plain version of the kernel: q (B, H, S, D), k/v (B, H, KV, D),
    mask (B, KV) {0,1}; queries start at column 0.  Softmax in f32,
    masked probabilities exactly 0, fully masked rows give 0.  Query
    rows are processed ``q_chunk`` at a time to bound the f32 logits."""
    b, h, s, d = q.shape
    kv = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    kf, vf = k.float(), v.float()
    valid_kv = mask[:, None, None, :].bool()
    kv_idx = torch.arange(kv, device=q.device)
    outs = []
    for q0 in range(0, s, q_chunk):
        qc = q[:, :, q0:q0 + q_chunk].float()
        logits = (qc @ kf.transpose(-1, -2)) * scale          # (B, H, c, KV)
        valid = valid_kv
        if causal:
            q_idx = torch.arange(q0, q0 + qc.shape[2], device=q.device)
            valid = valid & (kv_idx[None, :] <= q_idx[:, None])[None, None]
        m = torch.where(valid, logits, NEG_INF).amax(dim=-1, keepdim=True)
        p = torch.where(valid, torch.exp(logits - m), 0.0)
        l = p.sum(dim=-1, keepdim=True)
        out = (p @ vf) / torch.where(l == 0, 1.0, l)
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=2)


# q, k, v, mask, out, B, H, S, KV, KV padded, D, (sb, sh, ss) for q, k, v,
# out, scale, causal, stream
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_KV_TILE = 128          # keys per kernel tile; the byte mask is padded to a multiple of it
_SMALL_TILE = 16        # chunked_attention's tiles of at most this many queries take one pass


def _strides(t: torch.Tensor):
    return [t.stride(i) for i in range(3)]


def flash_attention(q, k, v, mask, causal: bool = True) -> torch.Tensor:
    """Flash attention over (B, H, S, D) q and (B, H, KV, D) k/v with a
    (B, KV) validity mask.  Tensors may be strided views (the D axis
    contiguous), e.g. (B, S, H, D) buffers transposed; the output is a
    (B, H, S, D) view of a (B, S, H, D) buffer."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, h, s, d = q.shape
    kv = k.shape[2]
    if d not in (64, 128):
        raise ValueError(f"flash_attention kernel takes head_dim 64 or 128, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be bf16 on {q.device}")
        if t.stride(3) != 1 or any(t.stride(i) % 8 for i in range(3)) or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} needs a contiguous D axis, "
                             "strides that are multiples of 8 and 16-byte alignment")
    if k.shape != (b, h, kv, d) or v.shape != k.shape or mask.shape != (b, kv):
        raise ValueError("flash_attention: shape mismatch")
    # one byte per key, zero past KV up to a whole number of key tiles
    kvp = -(-kv // _KV_TILE) * _KV_TILE
    mask_u8 = torch.zeros((b, kvp), dtype=torch.uint8, device=q.device)
    mask_u8[:, :kv] = mask.to(q.device) != 0
    out = torch.empty((b, s, h, d), dtype=torch.bfloat16, device=q.device).transpose(1, 2)
    fn = build.function("flash_attention", "flash_attention_fwd", _ARGTYPES)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_u8.data_ptr(), out.data_ptr(),
        b, h, s, kv, kvp, d, *_strides(q), *_strides(k), *_strides(v), *_strides(out),
        1.0 / math.sqrt(d), int(causal), torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, M, K) @ (N, K, P) with f32 accumulation and an f32 result.
    On CUDA, half-precision operands stay as they are (``torch.bmm`` with
    ``out_dtype``); elsewhere the same products are taken in f32, which
    holds the exact product of two bf16 values."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def chunked_attention(q, k, v, mask, causal: bool = True, block_k: int = 512,
                      block_q: int = 512, k_scale=None, v_scale=None, kv_bshd: bool = False,
                      q_bshd: bool = False, q_offset: int = 0, q_abs=None,
                      scales_bhs: bool = False) -> torch.Tensor:
    """Online-softmax attention over ``block_q`` query tiles and
    ``block_k`` key chunks, with the reference's contract:

    * q (B, H, S, D), or (B, S, H, D) with ``q_bshd`` (the output follows
      q's layout); k/v (B, H, KV, D), or the cache's (B, KV, H, D) with
      ``kv_bshd``; mask (B, KV) {0,1};
    * int8 K/V with ``k_scale``/``v_scale``: key columns are converted to
      q's dtype, K's scale multiplies the f32 logits and V's the
      probabilities before their cast for p·v.  Scales follow k's layout,
      or are (B, H, KV) with ``scales_bhs``;
    * the causal position of a query is its cache column: ``q_offset`` +
      its index (a prefill segment, a one-token decode step), or, with
      ``q_abs`` (B, S), a column per row (a speculative pass, whose rows
      stand at different columns);
    * per tile: the full chunks in ascending order, then the ragged tail,
      which re-reads the last ``block_k`` rows with the rows the full
      chunks covered masked out.  With ``q_offset``, chunks wholly above
      the causal diagonal are skipped, which is exact (a fully masked
      chunk changes nothing); so a segment whose ``q_offset`` is a
      multiple of ``block_q`` gives the bits of the same rows of the
      one-shot call.  ``q_abs`` visits every chunk;
    * a tile of at most 16 queries (a decode step, a speculative pass)
      takes every key column in one pass instead — the same function; a
      chunk loop over so few queries is bound by its launches — one batch
      row at a time, with its rows padded to 16 that attend nothing and
      are dropped.  A tile's arithmetic then depends neither on how many
      queries share it, nor on how many batch rows there are, nor on
      which route (``q_offset`` or ``q_abs``) gives their columns;
    * masked probabilities are exactly 0 and fully masked rows give 0.

    Both products take operands in q's dtype with f32 accumulation.  No
    (B, H, S, KV) tensor is made, and a whole-cache conversion only for a
    tile of at most 16 queries."""
    if q_bshd:
        b, s, h, d = q.shape
    else:
        b, h, s, d = q.shape
    dtype = q.dtype
    kv_axis = 1 if kv_bshd else 2
    kv_len = k.shape[kv_axis]
    sc_axis = 2 if scales_bhs else kv_axis
    scale = 1.0 / math.sqrt(d)
    dev = q.device

    def heads_major(t):           # a (B, KV-slice, H, ...) slice → (B, H, ...)
        return t.transpose(1, 2) if kv_bshd else t

    def scales_bhk(t):            # a scale slice → (B, H, KV-slice)
        return t.transpose(1, 2) if kv_bshd and not scales_bhs else t

    def attend(carry, q_blk, q_pos, kv_start, blk, min_kv=0):
        acc, m_i, l_i = carry
        bq = q_blk.shape[2]
        k_blk = heads_major(k.narrow(kv_axis, kv_start, blk)).to(dtype).contiguous()
        v_blk = heads_major(v.narrow(kv_axis, kv_start, blk)).to(dtype).contiguous()
        logits = _bmm_f32(q_blk.reshape(b * h, bq, d),
                          k_blk.reshape(b * h, blk, d).transpose(1, 2)).view(b, h, bq, blk)
        logits = logits * scale
        if k_scale is not None:
            logits = logits * scales_bhk(k_scale.narrow(sc_axis, kv_start, blk))[:, :, None, :]
        kv_pos = torch.arange(kv_start, kv_start + blk, device=dev)
        valid = mask[:, kv_start:kv_start + blk].bool()[:, None, None, :]
        if min_kv:
            valid = valid & (kv_pos >= min_kv)
        if causal:
            valid = valid & (kv_pos <= q_pos)
        logits = torch.where(valid, logits, NEG_INF)
        m_new = torch.maximum(m_i, logits.amax(dim=-1, keepdim=True))
        p = torch.where(valid, torch.exp(logits - m_new), 0.0)
        alpha = torch.exp(m_i - m_new)
        l_new = alpha * l_i + p.sum(dim=-1, keepdim=True)
        if v_scale is not None:
            p = p * scales_bhk(v_scale.narrow(sc_axis, kv_start, blk))[:, :, None, :]
        pv = _bmm_f32(p.to(dtype).reshape(b * h, bq, blk), v_blk.reshape(b * h, blk, d))
        return acc * alpha + pv.view(b, h, bq, d), m_new, l_new

    def one_pass(bi, q_row, q_pos):
        """Every key column of batch row ``bi`` at once: one softmax over
        its whole cache.  Rows go one at a time: the batch count of a
        ``bmm`` and the row count of a reduction change how the card
        groups a row's sums, so a row's bits would follow the batch."""
        rows = q_row.shape[2]

        def row(t, axis=0):
            return t.narrow(axis, bi, 1)

        k_all = heads_major(row(k)).to(dtype, memory_format=torch.contiguous_format)
        v_all = heads_major(row(v)).to(dtype, memory_format=torch.contiguous_format)
        logits = _bmm_f32(q_row.reshape(h, rows, d), k_all.reshape(h, kv_len, d).transpose(1, 2))
        logits = logits.view(1, h, rows, kv_len) * scale
        if k_scale is not None:
            logits = logits * scales_bhk(row(k_scale))[:, :, None, :]
        valid = row(mask).bool()[:, None, None, :]
        if causal:
            valid = valid & (torch.arange(kv_len, device=dev) <= q_pos)
        logits = torch.where(valid, logits, NEG_INF)
        p = torch.where(valid, torch.exp(logits - logits.amax(dim=-1, keepdim=True)), 0.0)
        # a row sum over a length that is not a multiple of the vector
        # width groups its terms by where the row starts in memory, i.e. by
        # the query's place in the tile: sum over a padded length
        l_i = torch.nn.functional.pad(p, (0, -kv_len % 16)).sum(dim=-1, keepdim=True)
        if v_scale is not None:
            p = p * scales_bhk(row(v_scale))[:, :, None, :]
        acc = _bmm_f32(p.to(dtype).reshape(h, rows, kv_len), v_all.reshape(h, kv_len, d))
        return acc.view(1, h, rows, d), l_i

    num_full = kv_len // block_k
    tail_len = kv_len - num_full * block_k
    tail_blk = min(block_k, kv_len)
    tail_start = kv_len - tail_blk
    tiles = []
    for qs in range(0, s, block_q):
        bq = min(block_q, s - qs)
        q_blk = q[:, qs:qs + bq].transpose(1, 2) if q_bshd else q[:, :, qs:qs + bq]
        if q_abs is not None:
            # per-row columns: no diagonal shared by the rows to skip at
            q_pos = q_abs[:, qs:qs + bq].to(dev)                          # (B, bq)
            nf, need_tail = num_full, tail_len > 0
        else:
            q_pos = torch.arange(q_offset + qs, q_offset + qs + bq, device=dev)[None]
            q_end = q_offset + qs + bq - 1
            if causal:
                nf = min((q_end + block_k) // block_k, num_full)
                need_tail = tail_len > 0 and q_end >= num_full * block_k
            else:
                nf, need_tail = num_full, tail_len > 0
        if bq <= _SMALL_TILE:
            # padding rows at column -1 fail every causal test
            q_blk = torch.nn.functional.pad(q_blk, (0, 0, 0, _SMALL_TILE - bq))
            q_pos = torch.nn.functional.pad(q_pos, (0, _SMALL_TILE - bq), value=-1)[:, None, :, None]
            parts = [one_pass(bi, q_blk[bi:bi + 1].contiguous(),
                              q_pos[bi:bi + 1] if q_pos.shape[0] > 1 else q_pos)
                     for bi in range(b)]
            acc, l_i = (torch.cat(t) for t in zip(*parts))
        else:
            q_blk, q_pos = q_blk.contiguous(), q_pos[:, None, :, None]    # (B|1, 1, bq, 1)
            carry = (torch.zeros((b, h, bq, d), dtype=torch.float32, device=dev),
                     torch.full((b, h, bq, 1), NEG_INF, dtype=torch.float32, device=dev),
                     torch.zeros((b, h, bq, 1), dtype=torch.float32, device=dev))
            for c in range(nf):
                carry = attend(carry, q_blk, q_pos, c * block_k, block_k)
            if need_tail or nf == 0:
                carry = attend(carry, q_blk, q_pos, tail_start, tail_blk,
                               min_kv=num_full * block_k if tail_start else 0)
            acc, _, l_i = carry
        acc, l_i = acc[:, :, :bq], l_i[:, :, :bq]
        out = (acc / torch.where(l_i == 0, 1.0, l_i)).to(dtype)
        tiles.append(out.transpose(1, 2) if q_bshd else out)
    return torch.cat(tiles, dim=1 if q_bshd else 2)
