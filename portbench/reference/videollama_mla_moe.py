"""The VideoLLaMA backbone with a DeepSeek-V3 decoder (Kimi-VL-A3B's: latent
attention and sigmoid-routed experts) in plain float32, one clip at a
time.

The prefix is ``videollama.prefix_embeds``'s (the towers, the connector,
the audio projector, the prompt).  The decoder follows ``transformers``'
``models/deepseek_v3/modeling_deepseek_v3.py`` equation for equation over
the unpadded ``[prefix][served tokens]``: no cache, no batching, the
experts as the plain loop over experts.  Departures from the published
code: the weights' layouts (dense kernels (in, out), the router's kernel
(hidden, experts) with ``e_score_correction_bias`` as ``router.bias``,
the routed experts stacked (in, experts, out), gate columns before up
columns in ``gate_up``); ``q_lora_rank`` null, one expert group and no
rope scaling only; every product and the softmax in float32; queries
``q_block`` at a time.  Each weight is widened to float32 where it is
read (an expert's slice at a time), so the bf16 weights are never held in
float32 at once.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import common
from portbench.reference.common import Weights
from portbench.reference.videollama import prefix_embeds

LATENT_NORM_EPS = 1e-6      # DeepseekV3RMSNorm's default, kv_a_layernorm's eps


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return scale * (x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float, interleave: bool):
    """(S, H, d): ``apply_rotary_pos_emb``, or with ``interleave``
    ``apply_rotary_pos_emb_interleave`` (its output de-interleaved)."""
    s, h, d = x.shape
    if interleave:
        x = x.view(s, h, d // 2, 2).transpose(-1, -2).reshape(s, h, d)
    inv_freq = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    freqs = positions.float()[:, None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)[:, None, :]
    rotated = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * emb.cos() + rotated * emb.sin()


def attention(w: Weights, x: torch.Tensor, cfg: dict, q_block: int = 1024) -> torch.Tensor:
    """``DeepseekV3Attention`` (``q_lora_rank`` null) over (S, hidden)."""
    s = x.shape[0]
    h, r = cfg["num_heads"], cfg["kv_lora_rank"]
    nope, rd, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    pos = torch.arange(s, device=x.device)
    q = (x @ w("q_proj.kernel")).view(s, h, nope + rd)
    q_pass, q_rot = q.split([nope, rd], dim=-1)
    k_pass, k_rot = (x @ w("kv_a_proj_with_mqa.kernel")).split([r, rd], dim=-1)
    k_pass = rms_norm(k_pass, w("kv_a_layernorm.scale"), LATENT_NORM_EPS)
    k_pass, v = (k_pass @ w("kv_b_proj.kernel")).view(s, h, nope + vd).split([nope, vd], dim=-1)
    q_rot = rope(q_rot, pos, cfg["rope_theta"], cfg["rope_interleave"])
    k_rot = rope(k_rot[:, None, :], pos, cfg["rope_theta"], cfg["rope_interleave"])
    qs = torch.cat([q_pass, q_rot], dim=-1).transpose(0, 1)
    ks = torch.cat([k_pass, k_rot.expand(s, h, rd)], dim=-1).transpose(0, 1)
    vs = v.transpose(0, 1)
    out = torch.empty((h, s, vd), device=x.device)
    for q0 in range(0, s, q_block):
        q1 = min(q0 + q_block, s)
        logits = qs[:, q0:q1] @ ks[:, :q1].transpose(1, 2) * (nope + rd) ** -0.5
        logits = logits.masked_fill(~(pos[None, :q1] <= pos[q0:q1, None]), float("-inf"))
        out[:, q0:q1] = logits.softmax(-1) @ vs[:, :q1]
    return out.transpose(0, 1).reshape(s, h * vd) @ w("o_proj.kernel")


def mlp(w: Weights, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w("gate_proj.kernel")) * (x @ w("up_proj.kernel"))) @ w("down_proj.kernel")


def moe(w: Weights, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """``DeepseekV3TopkRouter`` and ``DeepseekV3MoE``: sigmoid scores, the
    biased choice, the unbiased weights renormalised and scaled, the plain
    loop over the experts, then the shared experts."""
    scores = (x @ w("router.kernel")).sigmoid()
    ids = torch.topk(scores + w("router.bias")[None], k=cfg["num_experts_per_tok"], dim=-1,
                     sorted=False)[1]
    weights = scores.gather(1, ids)
    if cfg["norm_topk_prob"]:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
    weights = weights * cfg["routed_scaling_factor"]
    width = cfg["moe_intermediate_size"]
    gate_up, down = w.t[w.prefix + "experts.gate_up.kernel"], w.t[w.prefix + "experts.down.kernel"]
    out = torch.zeros_like(x)
    for e in range(cfg["n_routed_experts"]):
        tokens, slots = torch.where(ids == e)
        if tokens.numel() > 0:
            hid = x[tokens] @ gate_up[:, e].float()
            y = (F.silu(hid[:, :width]) * hid[:, width:]) @ down[:, e].float()
            out.index_add_(0, tokens, y * weights[tokens, slots][:, None])
    return out + mlp(w.sub("shared_experts."), x)


def decoder_logits(w: Weights, embeds: torch.Tensor, at: torch.Tensor, cfg: dict):
    """(S, hidden) embeddings of one unpadded causal sequence → (len(at), V)
    float32 logits at the positions ``at``."""
    x = embeds.float()
    eps = cfg["rms_norm_eps"]
    for i in range(cfg["num_layers"]):
        b = w.sub(f"layers.{i}.")
        x = x + attention(b.sub("attn."), rms_norm(x, b("input_norm.scale"), eps), cfg)
        h = rms_norm(x, b("post_attn_norm.scale"), eps)
        if cfg["n_routed_experts"] and i >= cfg["first_k_dense_replace"]:
            x = x + moe(b.sub("mlp."), h, cfg)
        else:
            x = x + mlp(b.sub("mlp."), h)
    return rms_norm(x[at], w("final_norm.scale"), eps) @ w("lm_head.kernel")


def served_logits(w: Weights, model: dict, audio: dict, clip: dict, served: list) -> torch.Tensor:
    prefix = prefix_embeds(w, model, audio, clip)
    llm = w.sub("llm.")
    seq = torch.cat([prefix, common.embed(llm, served[:-1])]) if len(served) > 1 else prefix
    at = torch.arange(prefix.shape[0] - 1, prefix.shape[0] - 1 + len(served), device=seq.device)
    logits = decoder_logits(llm, seq, at, model["llm"])
    return logits[:, :model["llm"]["vocab_size"]]
