"""A plain float32 reference of the DeepSeek-V3 decoder that Kimi-VL-A3B's
language model is: ``transformers``' ``models/deepseek_v3/
modeling_deepseek_v3.py`` equation for equation, in plain ``torch`` with
no kernel, cache or batching, over one unpadded causal sequence of
embeddings.  It imports nothing but ``torch``; on a card, run it under
:func:`strict_f32` (TF32 off).

Weights are a ``{name: tensor}`` dict under the port's parameter names
and layouts (``mraudio_tpu_torch/models/{llama,mla,moe}.py``), widened to
float32 where read.  Departures from the published code:

* the weights' layouts: dense kernels (in, out), the router's kernel
  (hidden, experts) with its ``e_score_correction_bias`` as
  ``router.bias``, and the routed experts stacked as (in, experts, out),
  gate columns before up columns in ``gate_up``;
* only ``q_lora_rank`` null (Kimi-VL-A3B's), one expert group
  (``n_group`` = ``topk_group`` = 1, for which the published group mask
  keeps every expert) and no rope scaling;
* every product and the softmax in float32, where the published code
  runs in the model dtype;
* the attention takes queries ``q_block`` at a time, so no (heads, S, S)
  tensor is made.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

LATENT_NORM_EPS = 1e-6      # DeepseekV3RMSNorm's default, kv_a_layernorm's eps


@contextlib.contextmanager
def strict_f32():
    """float32 matmuls without TF32, for the duration."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _w(w: dict, name: str) -> torch.Tensor:
    return w[name].float()


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """``DeepseekV3RMSNorm``."""
    return scale * (x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float, interleave: bool):
    """(S, H, d) → the roped vectors, as ``apply_rotary_pos_emb`` (halves)
    or, with ``interleave``, ``apply_rotary_pos_emb_interleave``, whose
    output keeps the de-interleaved order."""
    s, h, d = x.shape
    if interleave:
        x = x.view(s, h, d // 2, 2).transpose(-1, -2).reshape(s, h, d)
    inv_freq = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    freqs = positions.float()[:, None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)[:, None, :]
    rotated = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * emb.cos() + rotated * emb.sin()


def attention(w: dict, p: str, x: torch.Tensor, cfg: dict, q_block: int = 1024):
    """``DeepseekV3Attention`` (``q_lora_rank`` null) over (S, hidden)."""
    s = x.shape[0]
    h, r = cfg["num_heads"], cfg["kv_lora_rank"]
    nope, rd, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    pos = torch.arange(s, device=x.device)
    q = (x @ _w(w, p + "q_proj.kernel")).view(s, h, nope + rd)
    q_pass, q_rot = q.split([nope, rd], dim=-1)
    ckv = x @ _w(w, p + "kv_a_proj_with_mqa.kernel")
    k_pass, k_rot = ckv.split([r, rd], dim=-1)
    k_pass = rms_norm(k_pass, _w(w, p + "kv_a_layernorm.scale"), LATENT_NORM_EPS)
    kv = (k_pass @ _w(w, p + "kv_b_proj.kernel")).view(s, h, nope + vd)
    k_pass, v = kv.split([nope, vd], dim=-1)
    q_rot = rope(q_rot, pos, cfg["rope_theta"], cfg["rope_interleave"])
    k_rot = rope(k_rot[:, None, :], pos, cfg["rope_theta"], cfg["rope_interleave"])
    qs = torch.cat([q_pass, q_rot], dim=-1).transpose(0, 1)              # (H, S, 192)
    ks = torch.cat([k_pass, k_rot.expand(s, h, rd)], dim=-1).transpose(0, 1)
    vs = v.transpose(0, 1)
    out = torch.empty((h, s, vd), device=x.device)
    for q0 in range(0, s, q_block):
        q1 = min(q0 + q_block, s)
        logits = qs[:, q0:q1] @ ks[:, :q1].transpose(1, 2) * (nope + rd) ** -0.5
        causal = pos[None, :q1] <= pos[q0:q1, None]
        logits = logits.masked_fill(~causal, float("-inf"))
        out[:, q0:q1] = logits.softmax(-1) @ vs[:, :q1]
    return out.transpose(0, 1).reshape(s, h * vd) @ _w(w, p + "o_proj.kernel")


def mlp(w: dict, p: str, x: torch.Tensor) -> torch.Tensor:
    """``DeepseekV3MLP``: SwiGLU."""
    gate, up = x @ _w(w, p + "gate_proj.kernel"), x @ _w(w, p + "up_proj.kernel")
    return (F.silu(gate) * up) @ _w(w, p + "down_proj.kernel")


def route(w: dict, p: str, x: torch.Tensor, cfg: dict):
    """``DeepseekV3TopkRouter``: ((T, k) expert ids, (T, k) weights)."""
    scores = (x @ _w(w, p + "router.kernel")).sigmoid()
    choice = scores + _w(w, p + "router.bias")[None]
    ids = torch.topk(choice, k=cfg["num_experts_per_tok"], dim=-1, sorted=False)[1]
    weights = scores.gather(1, ids)
    if cfg["norm_topk_prob"]:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
    return ids, weights * cfg["routed_scaling_factor"]


def moe(w: dict, p: str, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """``DeepseekV3MoE``: the plain loop over the experts, then the shared
    experts."""
    ids, weights = route(w, p, x, cfg)
    width = cfg["moe_intermediate_size"]
    gate_up, down = w[p + "experts.gate_up.kernel"], w[p + "experts.down.kernel"]
    out = torch.zeros_like(x)
    for e in range(cfg["n_routed_experts"]):
        tokens, slots = torch.where(ids == e)
        if tokens.numel() > 0:
            h = x[tokens] @ gate_up[:, e].float()
            y = (F.silu(h[:, :width]) * h[:, width:]) @ down[:, e].float()
            out.index_add_(0, tokens, y * weights[tokens, slots][:, None])
    return out + mlp(w, p + "shared_experts.", x)


def decoder_logits(w: dict, embeds: torch.Tensor, cfg: dict, at=None) -> torch.Tensor:
    """(S, hidden) embeddings of one unpadded causal sequence → (S, vocab)
    float32 logits, or the rows ``at``.  ``cfg`` holds ``LlamaConfig``'s
    fields."""
    x = embeds.float()
    eps = cfg["rms_norm_eps"]
    for i in range(cfg["num_layers"]):
        p = f"layers.{i}."
        x = x + attention(w, p + "attn.", rms_norm(x, _w(w, p + "input_norm.scale"), eps), cfg)
        h = rms_norm(x, _w(w, p + "post_attn_norm.scale"), eps)
        if cfg["n_routed_experts"] and i >= cfg["first_k_dense_replace"]:
            x = x + moe(w, p + "mlp.", h, cfg)
        else:
            x = x + mlp(w, p + "mlp.", h)
    x = x if at is None else x[at]
    return rms_norm(x, _w(w, "final_norm.scale"), eps) @ _w(w, "lm_head.kernel")
