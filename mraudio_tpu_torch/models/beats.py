"""BEATs audio encoder: patch-embed GEMM over the log-mel fbank, a
grouped-conv relative positional embedding, and post-LN transformer
layers with gated T5-bucketed relative position bias.  Input is one
audio chunk's fbank per row, (N, T_mel, n_mels)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mraudio_tpu_torch.config import BeatsConfig
from mraudio_tpu_torch.device import torch_dtype
from mraudio_tpu_torch.models.layers import (
    Attention, Dense, LayerNormFp32, Mlp, _empty, gelu_exact,
)


def t5_relative_buckets(relative_position: np.ndarray, num_buckets: int,
                        max_distance: int) -> np.ndarray:
    """Bidirectional T5 bucketing of relative positions (host-side)."""
    ret = np.zeros_like(relative_position)
    n_buckets = num_buckets // 2
    ret += (relative_position > 0).astype(np.int64) * n_buckets
    rel = np.abs(relative_position)
    max_exact = n_buckets // 2
    is_small = rel < max_exact
    large = max_exact + (
        np.log(np.maximum(rel, 1) / max_exact)
        / np.log(max_distance / max_exact)
        * (n_buckets - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, n_buckets - 1)
    ret += np.where(is_small, rel, large)
    return ret


class RelativePositionTable(nn.Module):
    """Shared bucketed relative-position bias table, reused by every
    layer."""

    def __init__(self, cfg: BeatsConfig):
        super().__init__()
        self.cfg = cfg
        self.rel_attn_bias = _empty(cfg.rel_pos_buckets, cfg.num_heads)

    def forward(self, seq_len: int) -> torch.Tensor:
        cfg = self.cfg
        rel = np.arange(seq_len)[None, :] - np.arange(seq_len)[:, None]
        buckets = t5_relative_buckets(rel, cfg.rel_pos_buckets, cfg.rel_pos_max_distance)
        idx = torch.from_numpy(buckets).to(self.rel_attn_bias.device)
        bias = self.rel_attn_bias[idx]                  # (L, L, H)
        return bias.permute(2, 0, 1)[None]              # (1, H, L, L)


class GatedBias(nn.Module):
    """Per-layer query-conditioned gate on the shared bias (BEATs'
    ``gru_rel_pos``): ``gate_a * (gate_b * grep_a - 1) + 2``."""

    def __init__(self, cfg: BeatsConfig, dtype: torch.dtype):
        super().__init__()
        head_dim = cfg.width // cfg.num_heads
        self.grep_linear = Dense(head_dim, 8, True, dtype)
        self.grep_a = _empty(cfg.num_heads)

    def forward(self, q: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        # q: (B, L, H, Dh) — the layer input split into heads
        g = self.grep_linear(q).float()                 # (B, L, H, 8)
        g = g.reshape(g.shape[:-1] + (2, 4)).sum(-1)
        gate_a, gate_b = torch.sigmoid(g).chunk(2, dim=-1)
        gate = gate_a * (gate_b * self.grep_a[None, None, :, None] - 1.0) + 2.0
        return gate.permute(0, 2, 1, 3) * bias          # (B,H,L,1) * (1,H,L,L)


class BeatsBlock(nn.Module):
    """Post-LN transformer layer."""

    def __init__(self, cfg: BeatsConfig, dtype: torch.dtype):
        super().__init__()
        self.attn = Attention(cfg.width, cfg.num_heads, dtype=dtype)
        self.norm1 = LayerNormFp32(cfg.width, cfg.layer_norm_eps)
        self.mlp = Mlp(cfg.width, cfg.mlp_dim, gelu_exact, dtype)
        self.norm2 = LayerNormFp32(cfg.width, cfg.layer_norm_eps)

    def forward(self, x, bias):
        x = self.norm1(x + self.attn(x, bias=bias))
        return self.norm2(x + self.mlp(x))


class BeatsEncoder(nn.Module):
    def __init__(self, cfg: BeatsConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = dt = torch_dtype(cfg.dtype)
        s = cfg.patch_stride
        self.patch_embed = Dense(s * s, cfg.conv_dim, True, dt)
        self.patch_norm = LayerNormFp32(cfg.conv_dim, cfg.layer_norm_eps)
        if cfg.conv_dim != cfg.width:
            self.post_extract_proj = Dense(cfg.conv_dim, cfg.width, True, dt)
        # torch conv layout (out, in/groups, k); flax keeps (k, in/groups, out)
        k = cfg.conv_pos_kernel
        self.pos_conv = nn.Module()
        self.pos_conv.kernel = _empty(cfg.width, cfg.width // cfg.conv_pos_groups, k)
        self.pos_conv.bias = _empty(cfg.width)
        self.pre_encoder_norm = LayerNormFp32(cfg.width, cfg.layer_norm_eps)
        self.rel_pos_bias = RelativePositionTable(cfg)
        self.gates = nn.ModuleList(GatedBias(cfg, dt) for _ in range(cfg.depth))
        self.blocks = nn.ModuleList(BeatsBlock(cfg, dt) for _ in range(cfg.depth))

    def forward(self, fbank: torch.Tensor) -> torch.Tensor:
        """fbank: (N, T_mel, n_mels) → (N, tokens, width)."""
        cfg, dt = self.cfg, self.dtype
        n, t, f = fbank.shape
        s = cfg.patch_stride
        gt, gf = t // s, f // s
        x = fbank[:, : gt * s, : gf * s].reshape(n, gt, s, gf, s)
        x = x.permute(0, 1, 3, 2, 4).reshape(n, gt * gf, s * s)
        x = self.patch_norm(self.patch_embed(x.to(dt)))
        if cfg.conv_dim != cfg.width:
            x = self.post_extract_proj(x)

        # Grouped conv1d positional embedding with wav2vec2's "SamePad":
        # (k//2, k//2 - 1) for even k — asymmetric, unlike padding="same".
        k = cfg.conv_pos_kernel
        pad = (k // 2, k // 2 - 1) if k % 2 == 0 else (k // 2, k // 2)
        xc = F.pad(x.transpose(1, 2), pad)                  # (N, C, L + k - 1)
        pos = F.conv1d(xc, self.pos_conv.kernel.to(dt), self.pos_conv.bias.to(dt),
                       groups=cfg.conv_pos_groups).transpose(1, 2)
        x = self.pre_encoder_norm(x + gelu_exact(pos))

        seq_len = x.shape[1]
        shared_bias = self.rel_pos_bias(seq_len)
        heads = x.unflatten(-1, (cfg.num_heads, cfg.width // cfg.num_heads))
        for gate, block in zip(self.gates, self.blocks):
            bias = gate(heads, shared_bias)
            x = block(x, bias)
            heads = x.unflatten(-1, (cfg.num_heads, cfg.width // cfg.num_heads))
        return x
