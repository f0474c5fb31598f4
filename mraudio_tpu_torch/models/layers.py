"""Shared building blocks.

Parameters keep the JAX package's layouts: a dense kernel is (in, out),
so multi-head projections are the flax (in, heads·head_dim) and
(heads·head_dim, out) kernels flattened.  Layer norms always reduce in
float32 and cast back.  Encoder attention is an explicit matmul with an
f32 softmax (never SDPA, whose fused backends take the softmax in other
precisions).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

# Large negative value for masked logits, shared with the attention ops:
# representable in bf16 and f32, and exp(NEG_INF - m) underflows to 0.
NEG_INF = -1e30

# Decode-shaped calls (a decode step's B rows, a speculative pass's B·W):
# on CUDA, row reductions and plain matmuls of fewer rows run padded to
# this many.  torch and cuBLAS lay out their work by the number of rows,
# so a row's bits could otherwise change with the rows beside it, and a
# speculative pass would not reproduce the one-token steps' tokens.
DECODE_ROWS = 32


def pad_rows(x2: torch.Tensor) -> torch.Tensor:
    """A 2-D CUDA tensor of fewer than :data:`DECODE_ROWS` rows, padded
    with zero rows to that many; anything else as it is."""
    if x2.is_cuda and x2.shape[0] < DECODE_ROWS:
        return F.pad(x2, (0, 0, 0, DECODE_ROWS - x2.shape[0]))
    return x2


def top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries along the last axis, in
    descending order, lowest index first among equal values (the order of
    ``jax.lax.top_k``; a stable descending sort keeps it)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf-based) GELU."""
    return F.gelu(x)


def _empty(*shape, dtype=torch.float32) -> nn.Parameter:
    # Values are filled by models/convert_jax.py (a JAX tree or the
    # seeded random init); nothing here draws random numbers.
    return nn.Parameter(torch.empty(*shape, dtype=dtype), requires_grad=False)


class Dense(nn.Module):
    """y = x @ kernel (+ bias) computed in ``dtype``: flax ``nn.Dense``
    semantics (operands and bias cast to the compute dtype, the product
    rounded to it before the bias add)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.kernel = _empty(in_features, out_features)
        self.bias = _empty(out_features) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class Embed(nn.Module):
    def __init__(self, num: int, features: int):
        super().__init__()
        self.embedding = _empty(num, features)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids.long(), self.embedding)


class LayerNormFp32(nn.Module):
    """LayerNorm computed in float32 regardless of activation dtype."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = _empty(features)
        self.bias = _empty(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.scale.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


class RMSNorm(nn.Module):
    """Llama RMSNorm; variance in fp32."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = _empty(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        flat = xf.reshape(-1, xf.shape[-1])
        var = pad_rows(flat).square().mean(dim=-1, keepdim=True)[:flat.shape[0]]
        y = xf * torch.rsqrt(var.reshape(xf.shape[:-1] + (1,)) + self.eps)
        return (y * self.scale.float()).to(x.dtype)


def dot_product_attention(q, k, v, mask=None, bias=None, scale=None):
    """q: (B, Nq, H, D); k/v: (B, Nk, H, D); mask broadcastable to
    (B, H, Nq, Nk) bool (True = attend); bias additive, same broadcast.
    Logits and softmax in f32, probabilities cast to v's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    if mask is not None:
        logits = torch.where(mask, logits, logits.new_tensor(NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class Attention(nn.Module):
    """Multi-head (optionally cross) attention."""

    def __init__(self, d_model: int, num_heads: int, kv_features: Optional[int] = None,
                 head_dim: Optional[int] = None, out_features: Optional[int] = None,
                 qkv_bias: bool = True, out_bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = head_dim or d_model // num_heads
        inner = num_heads * self.head_dim
        kv_features = kv_features or d_model
        self.q = Dense(d_model, inner, qkv_bias, dtype)
        self.k = Dense(kv_features, inner, qkv_bias, dtype)
        self.v = Dense(kv_features, inner, qkv_bias, dtype)
        self.out = Dense(inner, out_features or d_model, out_bias, dtype)

    def forward(self, x, kv=None, mask=None, bias=None):
        kv = x if kv is None else kv
        h, d = self.num_heads, self.head_dim
        q = self.q(x).unflatten(-1, (h, d))
        k = self.k(kv).unflatten(-1, (h, d))
        v = self.v(kv).unflatten(-1, (h, d))
        out = dot_product_attention(q, k, v, mask=mask, bias=bias)
        return self.out(out.flatten(-2))


class Mlp(nn.Module):
    def __init__(self, features: int, hidden_dim: int,
                 activation: Callable = gelu_exact,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.activation = activation
        self.fc1 = Dense(features, hidden_dim, True, dtype)
        self.fc2 = Dense(hidden_dim, features, True, dtype)

    def forward(self, x):
        return self.fc2(self.activation(self.fc1(x)))


def make_padding_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """(B, Nk) {0,1} → (B, 1, 1, Nk) bool attend-mask."""
    return attention_mask[:, None, None, :].bool()


def positions_from_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """HF-compatible position ids: cumsum(mask)-1 clamped at 0."""
    pos = torch.cumsum(attention_mask.to(torch.int32), dim=-1) - 1
    return pos.clamp_min(0).to(torch.int32)
