"""EVA-ViT-g/14 frame encoder: patch-embed GEMM, class token, learned
absolute position embeddings, pre-norm blocks with qkv bias, no final
norm (the assembly applies ``video_ln``).  224² → 257 tokens × 1408.

With ``keyframe_interval > 1`` and clips of ``n_frms`` frames (the
temporal-residual encoder, an approximation): every
``keyframe_interval``-th frame runs the full transformer; each other
frame runs it on its class token and its ``residual_tokens`` patches
that changed most against its keyframe (summed squared difference of
the patch embeddings), and those outputs overwrite the keyframe's
features at the same positions.

With ``grad_checkpoint`` and a gradient to take (a trainable leaf in
the encoder, or an input that needs one), each block is recomputed in
the backward (``torch.utils.checkpoint``).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mraudio_tpu_torch.config import ViTConfig
from mraudio_tpu_torch.device import torch_dtype
from mraudio_tpu_torch.models.layers import (
    Attention, Dense, LayerNormFp32, Mlp, _empty, gelu_exact, top_k_indices,
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
        self.cfg = cfg
        self.dtype = torch_dtype(cfg.dtype)
        p = cfg.patch_size
        self.patch_embed = Dense(p * p * 3, cfg.width, True, self.dtype)
        if cfg.use_class_token:
            self.cls_token = _empty(1, 1, cfg.width)
        self.pos_embed = _empty(1, cfg.seq_len, cfg.width)
        self.blocks = nn.ModuleList(ViTBlock(cfg, self.dtype) for _ in range(cfg.depth))

    def forward(self, images: torch.Tensor, n_frms: int | None = None) -> torch.Tensor:
        """images: (N, H, W, 3) normalized → (N, seq_len, width).  With
        ``n_frms`` the N images are N / n_frms clips of n_frms frames, and
        ``keyframe_interval > 1`` takes the temporal-residual path."""
        cfg, dt = self.cfg, self.dtype
        n, h, w, c = images.shape
        p = cfg.patch_size
        gh, gw = h // p, w // p
        num_patches = gh * gw
        # (gh, gw, p, p, c) patch order: one GEMM over p·p·3 features
        patches = images.reshape(n, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
        patches = patches.reshape(n, num_patches, p * p * c)
        x = self.patch_embed(patches.to(dt))
        pos = self.pos_embed
        patch_pos = (pos[:, 1:] if cfg.use_class_token else pos).to(dt)

        def with_cls(tokens):
            if not cfg.use_class_token:
                return tokens
            c0 = self.cls_token.expand(tokens.shape[0], 1, cfg.width).to(dt) + pos[:, :1].to(dt)
            return torch.cat([c0, tokens], dim=1)

        def run(tokens):
            for blk in self.blocks:
                if cfg.grad_checkpoint and torch.is_grad_enabled() and (
                        tokens.requires_grad or any(p.requires_grad for p in blk.parameters())):
                    tokens = checkpoint(blk, tokens, use_reentrant=False, preserve_rng_state=False)
                else:
                    tokens = blk(tokens)
            return tokens

        if not (cfg.keyframe_interval > 1 and n_frms is not None and n_frms > 1):
            return run(with_cls(x + patch_pos))

        t, k_int = n_frms, cfg.keyframe_interval
        b = n // t
        r = min(cfg.residual_tokens, num_patches)
        key_idx = list(range(0, t, k_int))
        nn_idx = [i for i in range(t) if i % k_int]
        nk, nn_ = len(key_idx), len(nn_idx)
        emb = x.reshape(b, t, num_patches, cfg.width)
        key_out = run(with_cls(emb[:, key_idx].reshape(b * nk, num_patches, cfg.width)
                               + patch_pos))
        seq_len = key_out.shape[1]
        key_out = key_out.reshape(b, nk, seq_len, cfg.width)
        if nn_ == 0:
            return key_out.reshape(b * nk, seq_len, cfg.width)

        # non-key frames: the R patches that changed most against their
        # keyframe (tied patches lowest index first, as in the reference)
        prev_key = [i // k_int for i in nn_idx]                       # index on the key axis
        nn_emb = emb[:, nn_idx]                                       # (B, nn, P, D)
        ref_emb = emb[:, [key_idx[j] for j in prev_key]]
        diff = (nn_emb.float() - ref_emb.float()).square().sum(dim=-1)       # (B, nn, P)
        idx = top_k_indices(diff, r)
        gather = idx[..., None].expand(-1, -1, -1, cfg.width)         # (B, nn, R, D)
        sel = nn_emb.gather(2, gather) + patch_pos[0][idx]
        sub_out = run(with_cls(sel.reshape(b * nn_, r, cfg.width)))
        sub_out = sub_out.reshape(b, nn_, sub_out.shape[1], cfg.width)

        # non-key frames take their keyframe's tokens, overwritten at the
        # recomputed patches (and with their own class token)
        nn_out = key_out[:, prev_key].clone()                         # (B, nn, L, D)
        off = 1 if cfg.use_class_token else 0
        if cfg.use_class_token:
            nn_out[:, :, 0] = sub_out[:, :, 0]
        nn_out.scatter_(2, gather + off, sub_out[:, :, off:])
        out = key_out.new_zeros((b, t, seq_len, cfg.width))
        out[:, key_idx] = key_out
        out[:, nn_idx] = nn_out
        return out.reshape(b * t, seq_len, cfg.width)
