"""Fabricated reference-format checkpoints: random weights in the REAL key
layouts (the JAX package's ``models/fabricate.py``, the same functions,
seeds and arrays for the same ``rng``).

The real artifacts (EVA-ViT-g ``eva_vit_g.pth``, BEATs
``BEATs_iter3_plus_AS2M.pt``, the Salesforce Q-Former bundles
``video_qformer.pth`` / ``audio_qformer_improved.pth``, reference
``models/xinstructblip.py:79,98``, BLIP-2 stage-1 ``blip2_pretrained.pth``,
``:192``, and the HF Vicuna-7B state dict, ``:147-149``) cannot be
downloaded without a network.  These functions emit state dicts with the
key names, shapes and quirks the real files carry (fused EVA qkv without
a key bias, the weight-normed BEATs ``pos_conv``, ``{"model": sd}``
wrappers, ``{modality}_Qformer.`` prefixes, ``ln_vision`` naming, a
32000-row HF vocab), so the whole convert → evaluate → score path runs
every line of the key routing without the real bytes.
``python -m mraudio_tpu_torch.cli.parity --fabricate`` runs on top of it.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = [
    "fabricate_eva_sd",
    "fabricate_beats_ckpt",
    "fabricate_qformer_bundle_ckpt",
    "fabricate_blip2_ckpt",
    "fabricate_llama_hf_sd",
    "fabricate_checkpoint_dir",
]


def fabricate_eva_sd(cfg, rng=None) -> dict:
    """EVA-ViT-g layout: fused ``attn.qkv.weight`` with separate
    ``q_bias``/``v_bias`` and NO key bias (the real file's quirk)."""
    rng = rng or np.random.default_rng(0)
    d, p = cfg.width, cfg.patch_size
    f32 = lambda *s: (rng.standard_normal(s) * 0.02).astype(np.float32)
    sd = {
        "patch_embed.proj.weight": f32(d, 3, p, p),
        "patch_embed.proj.bias": f32(d),
        "cls_token": f32(1, 1, d),
        "pos_embed": f32(1, cfg.seq_len, d),
    }
    for i in range(cfg.depth):
        pre = f"blocks.{i}"
        sd[f"{pre}.norm1.weight"] = np.ones(d, np.float32)
        sd[f"{pre}.norm1.bias"] = np.zeros(d, np.float32)
        sd[f"{pre}.norm2.weight"] = np.ones(d, np.float32)
        sd[f"{pre}.norm2.bias"] = np.zeros(d, np.float32)
        sd[f"{pre}.attn.qkv.weight"] = f32(3 * d, d)
        sd[f"{pre}.attn.q_bias"] = f32(d)
        sd[f"{pre}.attn.v_bias"] = f32(d)
        sd[f"{pre}.attn.proj.weight"] = f32(d, d)
        sd[f"{pre}.attn.proj.bias"] = f32(d)
        sd[f"{pre}.mlp.fc1.weight"] = f32(cfg.mlp_dim, d)
        sd[f"{pre}.mlp.fc1.bias"] = f32(cfg.mlp_dim)
        sd[f"{pre}.mlp.fc2.weight"] = f32(d, cfg.mlp_dim)
        sd[f"{pre}.mlp.fc2.bias"] = f32(d)
    return sd


def fabricate_beats_ckpt(cfg, rng=None) -> dict:
    """BEATs iter3+ layout: ``{"cfg": ..., "model": sd}`` wrapper,
    weight-normed pos_conv (``weight_g``/``weight_v``), shared layer-0
    relative-attention-bias table, per-layer grep gates, no k bias, no
    patch-embedding bias."""
    rng = rng or np.random.default_rng(1)
    d, w, p = cfg.conv_dim, cfg.width, cfg.patch_size
    f32 = lambda *s: (rng.standard_normal(s) * 0.02).astype(np.float32)
    sd = {
        "patch_embedding.weight": f32(d, 1, p, p),
        "layer_norm.weight": np.ones(d, np.float32),
        "layer_norm.bias": np.zeros(d, np.float32),
        # the real checkpoint stores the pos conv weight-normed (dim=2)
        "encoder.pos_conv.0.weight_g": np.abs(f32(1, 1, cfg.conv_pos_kernel)) + 0.5,
        "encoder.pos_conv.0.weight_v": f32(w, w // cfg.conv_pos_groups, cfg.conv_pos_kernel),
        "encoder.pos_conv.0.bias": f32(w),
        "encoder.layer_norm.weight": np.ones(w, np.float32),
        "encoder.layer_norm.bias": np.zeros(w, np.float32),
        "encoder.layers.0.self_attn.relative_attention_bias.weight":
            f32(cfg.rel_pos_buckets, cfg.num_heads),
    }
    if d != w:
        sd["post_extract_proj.weight"] = f32(w, d)
        sd["post_extract_proj.bias"] = f32(w)
    for i in range(cfg.depth):
        pre = f"encoder.layers.{i}"
        for proj in ("q_proj", "v_proj", "out_proj"):
            sd[f"{pre}.self_attn.{proj}.weight"] = f32(w, w)
            sd[f"{pre}.self_attn.{proj}.bias"] = f32(w)
        sd[f"{pre}.self_attn.k_proj.weight"] = f32(w, w)  # no k bias
        sd[f"{pre}.self_attn.grep_linear.weight"] = f32(8, w // cfg.num_heads)
        sd[f"{pre}.self_attn.grep_linear.bias"] = f32(8)
        sd[f"{pre}.self_attn.grep_a"] = np.ones((1, cfg.num_heads, 1, 1), np.float32)
        sd[f"{pre}.self_attn_layer_norm.weight"] = np.ones(w, np.float32)
        sd[f"{pre}.self_attn_layer_norm.bias"] = np.zeros(w, np.float32)
        sd[f"{pre}.fc1.weight"] = f32(cfg.mlp_dim, w)
        sd[f"{pre}.fc1.bias"] = f32(cfg.mlp_dim)
        sd[f"{pre}.fc2.weight"] = f32(w, cfg.mlp_dim)
        sd[f"{pre}.fc2.bias"] = f32(w)
        sd[f"{pre}.final_layer_norm.weight"] = np.ones(w, np.float32)
        sd[f"{pre}.final_layer_norm.bias"] = np.zeros(w, np.float32)
    return {"cfg": {"fabricated": True}, "model": sd}


def _qformer_sd(qcfg, prefix: str, encoder_width: int, rng) -> dict:
    """BertLMHeadModel Q-Former keys under ``prefix`` (e.g.
    ``video_Qformer.``): cross-attention every ``cross_attention_freq``
    layers, paired ``*_query`` FFN stems, the LAVIS layout ``init_Qformer``
    routes (reference ``models/xinstructblip.py:614-655``)."""
    h = qcfg.hidden_size
    f32 = lambda *s: (rng.standard_normal(s) * 0.02).astype(np.float32)
    sd = {
        f"{prefix}bert.embeddings.word_embeddings.weight": f32(qcfg.vocab_size, h),
        f"{prefix}bert.embeddings.position_embeddings.weight":
            f32(qcfg.max_position_embeddings, h),
        f"{prefix}bert.embeddings.LayerNorm.weight": np.ones(h, np.float32),
        f"{prefix}bert.embeddings.LayerNorm.bias": np.zeros(h, np.float32),
    }
    for i in range(qcfg.num_layers):
        pre = f"{prefix}bert.encoder.layer.{i}"
        blocks = [("attention", h)]
        if i % qcfg.cross_attention_freq == 0:
            blocks.append(("crossattention", encoder_width))
        for blk, kv_w in blocks:
            sd[f"{pre}.{blk}.self.query.weight"] = f32(h, h)
            sd[f"{pre}.{blk}.self.query.bias"] = f32(h)
            sd[f"{pre}.{blk}.self.key.weight"] = f32(h, kv_w)
            sd[f"{pre}.{blk}.self.key.bias"] = f32(h)
            sd[f"{pre}.{blk}.self.value.weight"] = f32(h, kv_w)
            sd[f"{pre}.{blk}.self.value.bias"] = f32(h)
            sd[f"{pre}.{blk}.output.dense.weight"] = f32(h, h)
            sd[f"{pre}.{blk}.output.dense.bias"] = f32(h)
            sd[f"{pre}.{blk}.output.LayerNorm.weight"] = np.ones(h, np.float32)
            sd[f"{pre}.{blk}.output.LayerNorm.bias"] = np.zeros(h, np.float32)
        for stem in ("intermediate", "intermediate_query"):
            sd[f"{pre}.{stem}.dense.weight"] = f32(qcfg.intermediate_size, h)
            sd[f"{pre}.{stem}.dense.bias"] = f32(qcfg.intermediate_size)
        for stem in ("output", "output_query"):
            sd[f"{pre}.{stem}.dense.weight"] = f32(h, qcfg.intermediate_size)
            sd[f"{pre}.{stem}.dense.bias"] = f32(h)
            sd[f"{pre}.{stem}.LayerNorm.weight"] = np.ones(h, np.float32)
            sd[f"{pre}.{stem}.LayerNorm.bias"] = np.zeros(h, np.float32)
    return sd


def fabricate_qformer_bundle_ckpt(model_cfg, modality: str, rng=None) -> dict:
    """Per-modality bundle (``video_qformer.pth`` /
    ``audio_qformer_improved.pth``): ``{"model": sd}`` with
    ``{modality}_Qformer.`` / ``{modality}_llm_proj.`` /
    ``{modality}_query_tokens`` keys, and the video LN stored under the
    Salesforce bundle's ``ln_vision`` name (the quirk
    ``convert_qformer_bundle`` routes, reference ``:694-696``)."""
    rng = rng or np.random.default_rng(2 if modality == "video" else 3)
    qcfg = model_cfg.qformer
    enc_w = model_cfg.vit.width if modality == "video" else model_cfg.beats.width
    h = qcfg.hidden_size
    f32 = lambda *s: (rng.standard_normal(s) * 0.02).astype(np.float32)
    sd = _qformer_sd(qcfg, f"{modality}_Qformer.", enc_w, rng)
    sd[f"{modality}_query_tokens"] = f32(1, qcfg.num_query_tokens, h)
    ln = "ln_vision" if modality == "video" else f"{modality}_ln"
    sd[f"{ln}.weight"] = np.ones(enc_w, np.float32)
    sd[f"{ln}.bias"] = np.zeros(enc_w, np.float32)
    sd[f"{modality}_llm_proj.weight"] = f32(model_cfg.llm.hidden_size, h)
    sd[f"{modality}_llm_proj.bias"] = f32(model_cfg.llm.hidden_size)
    return {"model": sd}


def fabricate_blip2_ckpt(model_cfg, rng=None) -> dict:
    """BLIP-2 stage-1 fallback (``blip2_pretrained.pth``): both
    modalities' Q-Former keys, so the fallback overlay has real work."""
    rng = rng or np.random.default_rng(4)
    sd = {}
    for modality in model_cfg.modalities:
        sd.update(fabricate_qformer_bundle_ckpt(model_cfg, modality, rng)["model"])
    return {"model": sd}


def fabricate_llama_hf_sd(lcfg, rng=None, vocab: int | None = None) -> dict:
    """HF llama-family causal-LM layout (``model.layers.{i}...``).  The
    real Vicuna checkpoint carries the RAW 32000-row vocab; the [PAD] row
    is appended at load (``resize_token_embeddings``, reference
    ``models/xinstructblip.py:154``), so by default the fabricated state
    dict is one row SHORT of ``cfg.vocab_size`` and the converter's
    zero-pad path runs."""
    rng = rng or np.random.default_rng(5)
    v = (lcfg.vocab_size - 1) if vocab is None else vocab
    h, inter = lcfg.hidden_size, lcfg.intermediate_size
    kv_h = lcfg.num_kv_heads * lcfg.head_dim
    f32 = lambda *s: (rng.standard_normal(s) * 0.02).astype(np.float32)
    sd = {
        "model.embed_tokens.weight": f32(v, h),
        "model.norm.weight": np.ones(h, np.float32),
        "lm_head.weight": f32(v, h),
    }
    for i in range(lcfg.num_layers):
        pre = f"model.layers.{i}"
        sd[f"{pre}.input_layernorm.weight"] = np.ones(h, np.float32)
        sd[f"{pre}.post_attention_layernorm.weight"] = np.ones(h, np.float32)
        sd[f"{pre}.self_attn.q_proj.weight"] = f32(h, h)
        sd[f"{pre}.self_attn.k_proj.weight"] = f32(kv_h, h)
        sd[f"{pre}.self_attn.v_proj.weight"] = f32(kv_h, h)
        sd[f"{pre}.self_attn.o_proj.weight"] = f32(h, h)
        if lcfg.attention_bias:
            sd[f"{pre}.self_attn.q_proj.bias"] = f32(h)
            sd[f"{pre}.self_attn.k_proj.bias"] = f32(kv_h)
            sd[f"{pre}.self_attn.v_proj.bias"] = f32(kv_h)
        sd[f"{pre}.mlp.gate_proj.weight"] = f32(inter, h)
        sd[f"{pre}.mlp.up_proj.weight"] = f32(inter, h)
        sd[f"{pre}.mlp.down_proj.weight"] = f32(h, inter)
    return sd


# role → the reference's conventional filename
FILENAMES = {
    "vit": "eva_vit_g.pth",
    "beats": "BEATs_iter3_plus_AS2M.pt",
    "video_qformer": "video_qformer.pth",
    "audio_qformer": "audio_qformer_improved.pth",
    "blip2": "blip2_pretrained.pth",
    "llm": "vicuna_hf_state_dict.pth",
}


def fabricate_checkpoint_dir(model_cfg, out_dir: str, seed: int = 0) -> dict:
    """Write all six artifacts under ``out_dir`` with the reference's
    conventional filenames, one at a time, with ``torch.save`` (so that
    ``load_torch_state_dict`` takes its real deserialization path);
    returns ``{role: path}``."""
    import torch

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    makers = {
        "vit": lambda: fabricate_eva_sd(model_cfg.vit, rng),
        "beats": lambda: fabricate_beats_ckpt(model_cfg.beats, rng),
        "video_qformer": lambda: fabricate_qformer_bundle_ckpt(model_cfg, "video", rng),
        "audio_qformer": lambda: fabricate_qformer_bundle_ckpt(model_cfg, "audio", rng),
        "blip2": lambda: fabricate_blip2_ckpt(model_cfg, rng),
        "llm": lambda: fabricate_llama_hf_sd(model_cfg.llm, rng),
    }
    paths = {}
    for role, make in makers.items():     # in this order: rng draws follow it
        paths[role] = os.path.join(out_dir, FILENAMES[role])
        torch.save(_to_torch(make()), paths[role])
    return paths


def _to_torch(obj):
    import torch

    if isinstance(obj, dict):
        return {k: _to_torch(v) for k, v in obj.items()}
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj)
    return obj
