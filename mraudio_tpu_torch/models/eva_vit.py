"""EVA-ViT-g/14 frame encoder: patch-embed GEMM, class token, learned
absolute position embeddings, pre-norm blocks with qkv bias, no final
norm (the assembly applies ``video_ln``).  224² → 257 tokens × 1408.

Only the ``keyframe_interval=1`` path (every frame through the full
transformer) is ported.
"""

from __future__ import annotations

import torch
from torch import nn

from mraudio_tpu_torch.config import ViTConfig
from mraudio_tpu_torch.device import torch_dtype
from mraudio_tpu_torch.models.layers import (
    Attention, Dense, LayerNormFp32, Mlp, _empty, gelu_exact,
)


def _vit_activation(name: str):
    if name == "gelu":
        return gelu_exact
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu_tanh":
        return lambda x: torch.nn.functional.gelu(x, approximate="tanh")
    raise ValueError(f"unknown ViTConfig.mlp_act {name!r}")


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, dtype: torch.dtype):
        super().__init__()
        self.norm1 = LayerNormFp32(cfg.width, cfg.layer_norm_eps)
        self.attn = Attention(cfg.width, cfg.num_heads, dtype=dtype)
        self.norm2 = LayerNormFp32(cfg.width, cfg.layer_norm_eps)
        self.mlp = Mlp(cfg.width, cfg.mlp_dim, _vit_activation(cfg.mlp_act), dtype)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class EvaViT(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        if cfg.keyframe_interval != 1:
            raise NotImplementedError("temporal-residual ViT is not ported yet")
        self.cfg = cfg
        self.dtype = torch_dtype(cfg.dtype)
        p = cfg.patch_size
        self.patch_embed = Dense(p * p * 3, cfg.width, True, self.dtype)
        if cfg.use_class_token:
            self.cls_token = _empty(1, 1, cfg.width)
        self.pos_embed = _empty(1, cfg.seq_len, cfg.width)
        self.blocks = nn.ModuleList(ViTBlock(cfg, self.dtype) for _ in range(cfg.depth))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: (N, H, W, 3) normalized → (N, seq_len, width)."""
        cfg, dt = self.cfg, self.dtype
        n, h, w, c = images.shape
        p = cfg.patch_size
        gh, gw = h // p, w // p
        # (gh, gw, p, p, c) patch order: one GEMM over p·p·3 features
        patches = images.reshape(n, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
        patches = patches.reshape(n, gh * gw, p * p * c)
        x = self.patch_embed(patches.to(dt))
        pos = self.pos_embed
        if cfg.use_class_token:
            c0 = self.cls_token.expand(n, 1, cfg.width).to(dt) + pos[:, :1].to(dt)
            x = torch.cat([c0, x + pos[:, 1:].to(dt)], dim=1)
        else:
            x = x + pos.to(dt)
        for blk in self.blocks:
            x = blk(x)
        return x
