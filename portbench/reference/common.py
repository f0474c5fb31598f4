"""Plain float32 building blocks of the reference: layer norms, dense
layers, multi-head attention, the Kaldi fbank and BEATs, a ViT, the
Q-Former, and a Llama/Qwen2 decoder that returns the logits at chosen
positions of one unpadded sequence.

Weights come as a ``{name: tensor}`` dict in the serving layout (dense
kernels (in, out); int8 kernels with a per-output-channel scale; LoRA
A and B) and are widened to float32 where they are read.  Nothing here
batches unequal sequences, keeps a cache or calls a kernel of the
program; TF32 is off while the reference runs (:func:`strict_f32`).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def strict_f32():
    """float32 matmuls and convolutions without TF32, for the duration."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Weights:
    """Read access to a weight dict, widened to float32."""

    def __init__(self, tensors: dict, prefix: str = ""):
        self.t = tensors
        self.prefix = prefix

    def __call__(self, name: str) -> torch.Tensor:
        return self.t[self.prefix + name].float()

    def has(self, name: str) -> bool:
        return self.prefix + name in self.t

    def sub(self, prefix: str) -> "Weights":
        return Weights(self.t, self.prefix + prefix)


def dense(w: Weights, x: torch.Tensor) -> torch.Tensor:
    y = x @ w("kernel")
    return y + w("bias") if w.has("bias") else y


def layer_norm(w: Weights, x: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), w("scale"), w("bias"), eps)


def rms_norm(w: Weights, x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w("scale")


def activation(name: str):
    return {"gelu": F.gelu,
            "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
            "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x)}[name]


def mha(w: Weights, x, kv, heads: int, key_mask=None, bias=None) -> torch.Tensor:
    """Attention with q/k/v/out dense layers; ``key_mask`` (N, K) bool,
    ``bias`` added to the (N, H, Q, K) logits."""
    n, q_len, _ = x.shape
    q = dense(w.sub("q."), x).view(n, q_len, heads, -1)
    k = dense(w.sub("k."), kv).view(n, kv.shape[1], heads, -1)
    v = dense(w.sub("v."), kv).view(n, kv.shape[1], heads, -1)
    logits = torch.einsum("nqhd,nkhd->nhqk", q, k) / math.sqrt(q.shape[-1])
    if bias is not None:
        logits = logits + bias
    if key_mask is not None:
        logits = logits.masked_fill(~key_mask[:, None, None, :], float("-inf"))
    out = torch.einsum("nhqk,nkhd->nqhd", logits.softmax(-1), v)
    return dense(w.sub("out."), out.reshape(n, q_len, -1))


def mlp(w: Weights, x, act) -> torch.Tensor:
    return dense(w.sub("fc2."), act(dense(w.sub("fc1."), x)))


# ----------------------------------------------------------------------
# Vision: normalization and a ViT (pre-norm blocks, learned positions)
# ----------------------------------------------------------------------


def normalize(frames_u8: torch.Tensor, mean, std) -> torch.Tensor:
    x = frames_u8.float() / 255.0
    return (x - torch.tensor(mean, device=x.device)) / torch.tensor(std, device=x.device)


def vit(w: Weights, images: torch.Tensor, cfg: dict, frames_per_pass: int = 15):
    """(N, H, W, 3) normalized frames → (N, tokens, width)."""
    outs = []
    for i in range(0, images.shape[0], frames_per_pass):
        outs.append(_vit(w, images[i:i + frames_per_pass], cfg))
    return torch.cat(outs)


def _vit(w: Weights, images, cfg):
    n, h, wd, c = images.shape
    p = cfg["patch_size"]
    gh, gw = h // p, wd // p
    patches = images.reshape(n, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
    x = dense(w.sub("patch_embed."), patches.reshape(n, gh * gw, p * p * c))
    pos = w("pos_embed")
    if cfg["use_class_token"]:
        cls = (w("cls_token") + pos[:, :1]).expand(n, 1, -1)
        x = torch.cat([cls, x + pos[:, 1:]], dim=1)
    else:
        x = x + pos
    act = activation(cfg["mlp_act"])
    eps = cfg["layer_norm_eps"]
    for i in range(cfg["depth"]):
        b = w.sub(f"blocks.{i}.")
        h1 = layer_norm(b.sub("norm1."), x, eps)
        x = x + mha(b.sub("attn."), h1, h1, cfg["num_heads"])
        x = x + mlp(b.sub("mlp."), layer_norm(b.sub("norm2."), x, eps), act)
    return x


# ----------------------------------------------------------------------
# Audio: the Kaldi fbank BEATs reads, and BEATs
# ----------------------------------------------------------------------

BEATS_FBANK_MEAN = 15.41663
BEATS_FBANK_STD = 6.55582


def _mel_banks(num_bins: int, n_fft: int, sample_rate: int) -> np.ndarray:
    def mel(f):
        return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)

    lo, hi = mel(20.0), mel(sample_rate / 2.0)
    delta = (hi - lo) / (num_bins + 1)
    fft_mel = mel(np.arange(n_fft // 2 + 1) * sample_rate / n_fft)
    left = lo + np.arange(num_bins)[:, None] * delta
    center, right = left + delta, left + 2 * delta
    up = (fft_mel[None] - left) / (center - left)
    down = (right - fft_mel[None]) / (right - center)
    return np.maximum(0.0, np.minimum(up, down)).T


def fbank_chunks(wave_i16: torch.Tensor, audio: dict, n_frms: int) -> torch.Tensor:
    """(N,) int16 waveform → (n_frms, chunk, mels) normalized log-mel
    chunks: ``torchaudio.compliance.kaldi.fbank`` as BEATs calls it
    (snip edges, DC removal, 0.97 preemphasis, povey window, power
    spectrum, mel banks over [20 Hz, Nyquist], log with a float eps floor)."""
    sr = audio["sampling_rate"]
    win = int(sr * audio["frame_length_ms"] / 1000)
    hop = int(sr * audio["frame_shift_ms"] / 1000)
    x = wave_i16.double()
    frames = x.unfold(0, win, hop)
    frames = frames - frames.mean(-1, keepdim=True)
    prev = torch.cat([frames[:, :1], frames[:, :-1]], dim=-1)
    frames = frames - audio["preemphasis"] * prev
    k = torch.arange(win, dtype=torch.float64, device=x.device)
    frames = frames * (0.5 - 0.5 * torch.cos(2 * math.pi * k / (win - 1))) ** 0.85
    n_fft = 1 << (win - 1).bit_length()
    spec = torch.fft.rfft(F.pad(frames, (0, n_fft - win)), dim=-1)
    power = spec.real.square() + spec.imag.square()
    banks = torch.from_numpy(_mel_banks(audio["num_mel_bins"], n_fft, sr)).to(x.device)
    eps = float(np.finfo(np.float32).eps)
    logmel = torch.log((power @ banks).clamp_min(eps)).float()
    logmel = (logmel - BEATS_FBANK_MEAN) / (2 * BEATS_FBANK_STD)
    total = n_frms * audio["mel_frames_per_chunk"]
    logmel = F.pad(logmel, (0, 0, 0, max(total - logmel.shape[0], 0)))[:total]
    return logmel.reshape(n_frms, audio["mel_frames_per_chunk"], -1)


def _t5_buckets(rel: np.ndarray, num_buckets: int, max_distance: int) -> np.ndarray:
    half = num_buckets // 2
    out = (rel > 0).astype(np.int64) * half
    a = np.abs(rel)
    exact = half // 2
    large = exact + (np.log(np.maximum(a, 1) / exact) / np.log(max_distance / exact)
                     * (half - exact)).astype(np.int64)
    return out + np.where(a < exact, a, np.minimum(large, half - 1))


def beats(w: Weights, fbank: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(N, T, mels) → (N, tokens, width): patch embedding and its norm,
    the projection, the grouped-conv positional embedding (SamePad), then
    post-norm layers whose logits carry the gated, bucketed relative
    position bias."""
    n, t, f = fbank.shape
    s, eps, heads = cfg["patch_stride"], cfg["layer_norm_eps"], cfg["num_heads"]
    gt, gf = t // s, f // s
    x = fbank[:, :gt * s, :gf * s].reshape(n, gt, s, gf, s).permute(0, 1, 3, 2, 4)
    x = layer_norm(w.sub("patch_norm."), dense(w.sub("patch_embed."), x.reshape(n, gt * gf, -1)),
                   eps)
    if cfg["conv_dim"] != cfg["width"]:
        x = dense(w.sub("post_extract_proj."), x)
    k = cfg["conv_pos_kernel"]
    pad = (k // 2, k // 2 - 1) if k % 2 == 0 else (k // 2, k // 2)
    pos = F.conv1d(F.pad(x.transpose(1, 2), pad), w("pos_conv.kernel"), w("pos_conv.bias"),
                   groups=cfg["conv_pos_groups"]).transpose(1, 2)
    x = layer_norm(w.sub("pre_encoder_norm."), x + F.gelu(pos), eps)
    length = x.shape[1]
    rel = np.arange(length)[None, :] - np.arange(length)[:, None]
    idx = torch.from_numpy(_t5_buckets(rel, cfg["rel_pos_buckets"],
                                       cfg["rel_pos_max_distance"])).to(x.device)
    shared = w("rel_pos_bias.rel_attn_bias")[idx].permute(2, 0, 1)[None]     # (1, H, L, L)
    for i in range(cfg["depth"]):
        g = w.sub(f"gates.{i}.")
        q = x.view(n, length, heads, -1)
        gl = dense(g.sub("grep_linear."), q).view(n, length, heads, 2, 4).sum(-1)
        gate_a, gate_b = torch.sigmoid(gl).chunk(2, dim=-1)
        gate = gate_a * (gate_b * g("grep_a")[None, None, :, None] - 1.0) + 2.0
        bias = gate.permute(0, 2, 1, 3) * shared
        b = w.sub(f"blocks.{i}.")
        x = layer_norm(b.sub("norm1."), x + mha(b.sub("attn."), x, x, heads, bias=bias), eps)
        x = layer_norm(b.sub("norm2."), x + mlp(b.sub("mlp."), x, F.gelu), eps)
    return x


# ----------------------------------------------------------------------
# Q-Former
# ----------------------------------------------------------------------


def qformer(w: Weights, queries: torch.Tensor, text_ids: torch.Tensor, enc: torch.Tensor,
            cfg: dict) -> torch.Tensor:
    """(N, Q, H) learned queries, (L,) text ids (unpadded, shared by the N
    rows), (N, S, E) encoder states → (N, Q, H) query outputs."""
    n, q_len, _ = queries.shape
    eps = cfg["layer_norm_eps"]
    text = w("word_embeddings.embedding")[text_ids] + w("position_embeddings")[:len(text_ids)]
    x = torch.cat([queries, text[None].expand(n, -1, -1)], dim=1)
    x = layer_norm(w.sub("embeddings_norm."), x, eps)
    for i in range(cfg["num_layers"]):
        b = w.sub(f"layers.{i}.")
        x = layer_norm(b.sub("self_norm."), x + mha(b.sub("self_attn."), x, x, cfg["num_heads"]),
                       eps)
        qs, ts = x[:, :q_len], x[:, q_len:]
        if i % cfg["cross_attention_freq"] == 0:
            qs = layer_norm(b.sub("cross_norm."),
                            qs + mha(b.sub("cross_attn."), qs, enc, cfg["num_heads"]), eps)
        qs = layer_norm(b.sub("ffn_norm_query."), qs + mlp(b.sub("mlp_query."), qs, F.gelu), eps)
        if ts.shape[1]:
            ts = layer_norm(b.sub("ffn_norm_text."), ts + mlp(b.sub("mlp_text."), ts, F.gelu), eps)
        x = torch.cat([qs, ts], dim=1)
    return x[:, :q_len]


# ----------------------------------------------------------------------
# Decoder: Llama / Qwen2 (GQA, optional q/k/v biases, int8 weights, LoRA)
# ----------------------------------------------------------------------


def _proj(w: Weights, x: torch.Tensor, lora_scale: float) -> torch.Tensor:
    if w.has("w_int8"):
        kernel = w("w_int8") * w("scale")
    else:
        kernel = w("kernel")
    y = x @ kernel
    if w.has("bias"):
        y = y + w("bias")
    if w.has("lora_a"):
        y = y + (x @ w("lora_a")) @ w("lora_b") * lora_scale
    return y


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    d = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d)
    ang = (positions.double()[:, None] * freqs)[:, None, :]
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def decoder_logits(w: Weights, embeds: torch.Tensor, at: torch.Tensor, cfg: dict,
                   lora_scale: float = 0.0, q_block: int = 1024) -> torch.Tensor:
    """(S, D) embeddings of one unpadded causal sequence (positions 0..S-1)
    → (len(at), V) float32 logits at the positions ``at``."""
    s = embeds.shape[0]
    heads, kv_heads = cfg["num_heads"], cfg["num_kv_heads"]
    hd = cfg["hidden_size"] // heads
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    pos = torch.arange(s, device=embeds.device)
    x = embeds.float()
    for i in range(cfg["num_layers"]):
        b = w.sub(f"layers.{i}.")
        h = rms_norm(b.sub("input_norm."), x, eps)
        q = _rope(_proj(b.sub("attn.q_proj."), h, lora_scale).view(s, heads, hd), pos, theta)
        k = _rope(_proj(b.sub("attn.k_proj."), h, lora_scale).view(s, kv_heads, hd), pos, theta)
        v = _proj(b.sub("attn.v_proj."), h, lora_scale).view(s, kv_heads, hd)
        k = k.repeat_interleave(heads // kv_heads, dim=1).transpose(0, 1)    # (H, S, hd)
        v = v.repeat_interleave(heads // kv_heads, dim=1).transpose(0, 1)
        q = q.transpose(0, 1)
        out = torch.empty_like(q)
        for q0 in range(0, s, q_block):
            q1 = min(q0 + q_block, s)
            logits = q[:, q0:q1] @ k[:, :q1].transpose(1, 2) / math.sqrt(hd)
            causal = pos[None, :q1] <= pos[q0:q1, None]
            logits = logits.masked_fill(~causal, float("-inf"))
            out[:, q0:q1] = logits.softmax(-1) @ v[:, :q1]
        x = x + _proj(b.sub("attn.o_proj."), out.transpose(0, 1).reshape(s, -1), lora_scale)
        h = rms_norm(b.sub("post_attn_norm."), x, eps)
        gate = _proj(b.sub("mlp.gate_proj."), h, lora_scale)
        up = _proj(b.sub("mlp.up_proj."), h, lora_scale)
        x = x + _proj(b.sub("mlp.down_proj."), F.silu(gate) * up, lora_scale)
    h = rms_norm(w.sub("final_norm."), x[at], eps)
    return h @ w("lm_head.kernel")


def embed(w: Weights, ids) -> torch.Tensor:
    table = w.t[w.prefix + "embed_tokens.embedding"]
    return table[torch.as_tensor(ids, device=table.device).long()].float()


# ----------------------------------------------------------------------
# Text: the byte tokenizer (ids 0-2 special, byte b at 3 + b)
# ----------------------------------------------------------------------

BOS = EOS = 2


def byte_ids(text: str, bos: bool = False) -> list:
    return ([BOS] if bos else []) + [3 + c for c in text.encode("utf-8")]


def byte_text(ids) -> str:
    """Decode as the served text: bytes only, specials skipped, stripped."""
    return bytes(t - 3 for t in ids if 3 <= t < 259).decode("utf-8", errors="ignore").strip()
