"""Analytic FLOP accounting for the inference pipeline (both backbones)
and the LoRA train step, and the card's peak for MFU.

Counts matmul FLOPs (2 per multiply-accumulate) per pipeline stage from
the configs, the same numbers as the JAX package's ``utils/flops.py``.
Elementwise work (norms, activations, softmax exp) is ignored: it is
bound by memory and below 1% of the matmul FLOPs at these widths.
"""

from __future__ import annotations

# Dense bf16 tensor-core peak per card, by ``torch.cuda.get_device_name()``
# (NVIDIA H100 SXM datasheet, without sparsity).
PEAK_FLOPS = {
    "H100": 989e12,
}


def peak_flops_for(device_name: str) -> float:
    """The bf16 peak of the card ``device_name`` names; a name the table
    does not know raises rather than give an MFU against a guess."""
    for key, val in PEAK_FLOPS.items():
        if key.lower() in device_name.lower():
            return val
    raise KeyError(f"no bf16 peak known for {device_name!r}; known: {sorted(PEAK_FLOPS)}")


def transformer_flops(
    tokens: int, width: int, depth: int, mlp_dim: int,
    kv_len: float | None = None, kv_width: int | None = None,
    n_mlp_mats: int = 2,
) -> float:
    """Forward matmul FLOPs of a transformer stack over ``tokens``
    positions.  ``kv_len`` is the attention context length per query
    (defaults to ``tokens``); ``n_mlp_mats=3`` for gated (SwiGLU) MLPs."""
    kv_len = tokens if kv_len is None else kv_len
    kv_width = width if kv_width is None else kv_width
    proj = 2 * tokens * (width * width * 2 + width * kv_width * 2)  # q,o + k,v
    attn = 2 * tokens * kv_len * width * 2                          # scores + values
    mlp = 2 * tokens * width * mlp_dim * n_mlp_mats
    return depth * (proj + attn + mlp)


def pipeline_flops(model_cfg, audio_cfg, n_frms: int, batch: int,
                   prefill_len: int, decode_tokens: int) -> dict:
    """Per-batch FLOPs of the full generate pipeline, by stage."""
    vit, beats, qf, llm = model_cfg.vit, model_cfg.beats, model_cfg.qformer, model_cfg.llm

    # frame encoder: n_frms folded frames per sample
    p_tok = vit.num_patches + (1 if vit.use_class_token else 0)
    f_embed = 2 * p_tok * (vit.patch_size ** 2 * 3) * vit.width  # per frame
    if vit.keyframe_interval > 1 and n_frms > 1:
        # temporal-residual: full blocks on keyframes, top-R subset on the
        # rest (the patch embedding still runs on every frame)
        nk = len(range(0, n_frms, vit.keyframe_interval))
        r_tok = min(vit.residual_tokens, vit.num_patches) + (1 if vit.use_class_token else 0)
        f_vit = batch * (
            nk * transformer_flops(p_tok, vit.width, vit.depth, vit.mlp_dim)
            + (n_frms - nk) * transformer_flops(r_tok, vit.width, vit.depth, vit.mlp_dim)
            + n_frms * f_embed
        )
    else:
        f_vit = batch * n_frms * (
            transformer_flops(p_tok, vit.width, vit.depth, vit.mlp_dim) + f_embed)

    # audio encoder: n_frms fbank chunks per sample
    a_tok = (audio_cfg.mel_frames_per_chunk // beats.patch_stride) * (
        beats.num_mel_bins // beats.patch_stride)
    f_beats = batch * n_frms * (
        transformer_flops(a_tok, beats.width, beats.depth, beats.mlp_dim)
        + 2 * a_tok * beats.patch_size ** 2 * beats.conv_dim)

    # dual Q-Formers: the queries (+ text) attend to the encoder tokens; the
    # self-attention stack is approximated over q + max_txt_len / 4 tokens
    q = qf.num_query_tokens
    qf_tokens = q + model_cfg.max_txt_len // 4
    n_cross = qf.num_layers // qf.cross_attention_freq
    f_qf = 0.0
    for enc_tok, enc_w in ((p_tok, vit.width), (a_tok, beats.width)):
        f_qf += batch * n_frms * (
            transformer_flops(qf_tokens, qf.hidden_size, qf.num_layers, qf.intermediate_size)
            # cross-attention K/V projections + attention, every other layer
            + n_cross * (2 * enc_tok * enc_w * qf.hidden_size * 2
                         + 2 * q * enc_tok * qf.hidden_size * 2))

    # LLM prefill (causal: the average context is half the prefix)
    kv_w = llm.num_kv_heads * llm.head_dim
    f_prefill = batch * transformer_flops(
        prefill_len, llm.hidden_size, llm.num_layers, llm.intermediate_size,
        kv_len=prefill_len / 2, kv_width=kv_w, n_mlp_mats=3)
    # generate computes the lm_head at the last position only
    f_prefill += batch * 2 * llm.hidden_size * llm.vocab_size

    # LLM decode: one token per step over the full KV context
    avg_ctx = prefill_len + decode_tokens / 2
    f_decode = batch * decode_tokens * (
        transformer_flops(1, llm.hidden_size, llm.num_layers, llm.intermediate_size,
                          kv_len=avg_ctx, kv_width=kv_w, n_mlp_mats=3)
        + 2 * llm.hidden_size * llm.vocab_size)

    total = f_vit + f_beats + f_qf + f_prefill + f_decode
    return {"vit": f_vit, "beats": f_beats, "qformer": f_qf,
            "prefill": f_prefill, "decode": f_decode, "total": total}


def train_step_flops(model_cfg, audio_cfg, n_frms: int, batch: int,
                     seq_len: int, grad_checkpoint: bool = True) -> dict:
    """Analytic FLOPs of one LoRA train micro-step (X-InstructBLIP).

    The encoders and Q-Formers are frozen and run forward only; the LLM
    runs forward plus a backward through the activations (about twice the
    forward; the LoRA weight gradients are negligible), plus one forward
    recompute under ``llm.grad_checkpoint``: 4x the forward (3x without);
    the full-sequence lm_head and CE run forward and backward through the
    frozen head (3x its forward)."""
    f = pipeline_flops(model_cfg, audio_cfg, n_frms, batch, seq_len, 0)
    llm = model_cfg.llm
    last_pos_head = batch * 2 * llm.hidden_size * llm.vocab_size
    enc = f["vit"] + f["beats"] + f["qformer"]
    llm_fwd = f["prefill"] - last_pos_head
    mult = 4.0 if grad_checkpoint else 3.0
    lm_head = batch * 2 * seq_len * llm.hidden_size * llm.vocab_size * 3.0
    total = enc + llm_fwd * mult + lm_head
    return {"encoders": enc, "llm": llm_fwd * mult, "lm_head": lm_head, "total": total}


def videollama_flops(cfg, audio_cfg, n_frms: int, batch: int,
                     prefill_len: int, decode_tokens: int) -> dict:
    """Per-batch FLOPs of the VideoLLaMA backbone's generate pipeline
    (``models/videollama.py``), by stage: the folded ViT and BEATs, the
    connector and the audio projector (two dense layers each), the LLM's
    prefill (last-position lm_head) and decode.  No Q-Formers."""
    vit, beats, llm = cfg.vit, cfg.beats, cfg.llm

    p_tok = vit.num_patches + (1 if vit.use_class_token else 0)
    f_embed = 2 * p_tok * (vit.patch_size ** 2 * 3) * vit.width
    f_vit = batch * n_frms * (transformer_flops(p_tok, vit.width, vit.depth, vit.mlp_dim)
                              + f_embed)

    a_tok = ((audio_cfg.mel_frames_per_chunk // beats.patch_stride)
             * (beats.num_mel_bins // beats.patch_stride))
    f_beats = batch * n_frms * (
        transformer_flops(a_tok, beats.width, beats.depth, beats.mlp_dim)
        + 2 * a_tok * beats.patch_size ** 2 * beats.conv_dim)

    # the pooled video tokens through the connector, one token per audio
    # chunk through the projector: two dense layers each
    v_tok = (n_frms // cfg.temporal_stride) * (vit.num_patches // (cfg.spatial_pool ** 2))
    d = llm.hidden_size
    f_conn = batch * 2 * (v_tok * (vit.width * d + d * d) + n_frms * (beats.width * d + d * d))

    kv_w = llm.num_kv_heads * llm.head_dim
    f_prefill = batch * transformer_flops(prefill_len, llm.hidden_size, llm.num_layers,
                                          llm.intermediate_size, kv_len=prefill_len / 2,
                                          kv_width=kv_w, n_mlp_mats=3)
    f_prefill += batch * 2 * llm.hidden_size * llm.vocab_size
    avg_ctx = prefill_len + decode_tokens / 2
    f_decode = batch * decode_tokens * (
        transformer_flops(1, llm.hidden_size, llm.num_layers, llm.intermediate_size,
                          kv_len=avg_ctx, kv_width=kv_w, n_mlp_mats=3)
        + 2 * llm.hidden_size * llm.vocab_size)

    total = f_vit + f_beats + f_conn + f_prefill + f_decode
    return {"vit": f_vit, "beats": f_beats, "connector": f_conn, "prefill": f_prefill,
            "decode": f_decode, "total": total}


def prefill_length(model_cfg, n_frms: int) -> int:
    """Static interleave length: per frame [cue + 32 query tokens] per
    modality + the timestamp budget, then duration + prompt.  The cue
    lengths are the byte tokenizer's (" video: " → 9 with BOS); a caller
    with a model should read its real ``prepare_text`` shapes."""
    per_frame = (9 + 32) * len(model_cfg.modalities) + model_cfg.tokens_per_timestamp
    return n_frms * per_frame + model_cfg.tokens_per_duration + model_cfg.max_txt_len
