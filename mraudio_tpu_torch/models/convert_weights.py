"""Checkpoint converters: the reference's torch checkpoints → the JAX
package's parameter layout → the port's modules (the JAX package's
``models/convert_weights.py``, but for int4 and the ``scan_layers``
layout).

The reference assembles its model from heterogeneous checkpoints with
key-routing surgery (``models/xinstructblip.py:614-655`` Q-Formers,
``:694-704`` layer norms, ``:706-735`` projections; EVA-ViT and BEATs
load inside LAVIS; Vicuna comes from HF):

========================  =============================================
checkpoint                converter
========================  =============================================
EVA-ViT-g ``.pth``        :func:`convert_eva_vit`
BEATs iter3+ ``.pt``      :func:`convert_beats`
video/audio Q-Former      :func:`convert_qformer_bundle` (Q-Former +
``*_qformer.pth``         query tokens + modality LN + LLM projection,
                          filtered by the ``{modality}_`` prefixes)
BLIP-2 stage-1 ``.pth``   :func:`convert_qformer_bundle` (fallback keys)
Vicuna-7B HF weights      :func:`convert_llama_hf` (+ :func:`quantize_llama_int8`)
VideoLLaMA2-AV merged     :func:`convert_videollama`: a CLIP
checkpoint                (:func:`convert_clip_vit_hf`) or SigLIP
                          (:func:`convert_siglip_vit_hf`) tower, the
                          connector and audio projector MLPs, BEATs, a
                          Llama or Qwen2 LLM
========================  =============================================

Every converter takes a flat ``{torch_name: np.ndarray}`` dict (use
:func:`load_torch_state_dict`) and returns the JAX package's nested
parameter subtree as numpy arrays, leaf for leaf the JAX converter's:
linear weights transpose (out, in) → (in, out), attention projections
reshape to DenseGeneral's (in, heads, head_dim).  The subtree goes into
the modules through ``convert_jax.overlay_jax_params_``, which keeps each
leaf's dtype (fp16 for a real Vicuna, f32 for the fabricated files), so
the later ``cast_params_for_inference`` sees the checkpoint's dtypes, as
in the JAX package.
"""

from __future__ import annotations

import logging

import numpy as np

from mraudio_tpu_torch.models.convert_jax import init_random_, overlay_jax_params_

logger = logging.getLogger("mraudio_tpu_torch")

# artifact role (``models/fabricate.py``'s names) → the RunConfig field
# that names its checkpoint
WEIGHT_FIELDS = {"vit": "vit_weights", "beats": "beats_weights",
                 "video_qformer": "video_qformer_weights",
                 "audio_qformer": "audio_qformer_weights",
                 "blip2": "blip2_stage1_weights", "llm": "llm_weights"}


def load_torch_state_dict(path: str) -> dict:
    """A torch checkpoint as ``{name: np.ndarray}``, read on the CPU; a
    ``{"model": sd}`` wrapper is unwrapped (the JAX package's semantics,
    ``weights_only=False``: the reference's files hold non-tensor entries,
    such as BEATs' ``cfg``)."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "model" in ckpt:
        ckpt = ckpt["model"]
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in ckpt.items()}


def _lin(sd, name):
    """(out,in) torch Linear → (in,out) kernel + bias."""
    out = {"kernel": sd[f"{name}.weight"].T}
    if f"{name}.bias" in sd:
        out["bias"] = sd[f"{name}.bias"]
    return out


def _heads(w, num_heads):
    """(out,in) → (in, heads, head_dim) for DenseGeneral q/k/v."""
    out_dim, in_dim = w.shape
    return w.T.reshape(in_dim, num_heads, out_dim // num_heads)


def _heads_bias(b, num_heads):
    return b.reshape(num_heads, -1)


def _ln(sd, name):
    return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}


# ---------------------------------------------------------------------------
# EVA-ViT-g
# ---------------------------------------------------------------------------


def convert_eva_vit(sd: dict, cfg) -> dict:
    """LAVIS ``eva_vit`` checkpoint → ``EvaViT`` params.

    EVA quirks: the fused ``attn.qkv.weight`` is split in thirds; there is
    no key bias (``attn.q_bias``/``attn.v_bias`` only: the k bias is
    zeros); the conv patch embed flattens to the (py, px, c) patch-vector
    order."""
    p = cfg.patch_size
    width = cfg.width
    heads = cfg.num_heads

    conv = sd["patch_embed.proj.weight"]  # (D, 3, p, p)
    kernel = conv.transpose(2, 3, 1, 0).reshape(p * p * 3, width)
    params = {
        "patch_embed": {"kernel": kernel, "bias": sd["patch_embed.proj.bias"]},
        "cls_token": sd["cls_token"],
        "pos_embed": sd["pos_embed"],
    }

    for i in range(cfg.depth):
        pre = f"blocks.{i}"
        qkv = sd[f"{pre}.attn.qkv.weight"]  # (3D, D)
        qw, kw, vw = np.split(qkv, 3, axis=0)
        q_bias = sd.get(f"{pre}.attn.q_bias", np.zeros(width, qkv.dtype))
        v_bias = sd.get(f"{pre}.attn.v_bias", np.zeros(width, qkv.dtype))
        params[f"block_{i}"] = {
            "norm1": {"LayerNorm_0": _ln(sd, f"{pre}.norm1")},
            "norm2": {"LayerNorm_0": _ln(sd, f"{pre}.norm2")},
            "attn": {
                "q": {"kernel": _heads(qw, heads), "bias": _heads_bias(q_bias, heads)},
                "k": {"kernel": _heads(kw, heads),
                      "bias": _heads_bias(np.zeros(width, qkv.dtype), heads)},
                "v": {"kernel": _heads(vw, heads), "bias": _heads_bias(v_bias, heads)},
                "out": {
                    "kernel": sd[f"{pre}.attn.proj.weight"].T.reshape(heads, width // heads,
                                                                      width),
                    "bias": sd[f"{pre}.attn.proj.bias"],
                },
            },
            "mlp": {
                "fc1": _lin(sd, f"{pre}.mlp.fc1"),
                "fc2": _lin(sd, f"{pre}.mlp.fc2"),
            },
        }
    return params


# ---------------------------------------------------------------------------
# Q-Former bundle (Q-Former + query tokens + LN + projection per modality)
# ---------------------------------------------------------------------------


def convert_qformer(sd: dict, cfg, prefix: str = "") -> dict:
    """BLIP-2 ``BertLMHeadModel`` weights → ``QFormer`` params.

    ``sd`` keys are relative to the Q-Former root (``bert.…``), already
    stripped of the ``{modality}_Qformer.`` routing prefix the reference
    removes at ``models/xinstructblip.py:642-651``."""
    g = lambda name: sd[f"{prefix}{name}"]
    heads = cfg.num_heads

    params = {
        "word_embeddings": {"embedding": g("bert.embeddings.word_embeddings.weight")},
        "position_embeddings": g("bert.embeddings.position_embeddings.weight"),
        "embeddings_norm": {
            "LayerNorm_0": {
                "scale": g("bert.embeddings.LayerNorm.weight"),
                "bias": g("bert.embeddings.LayerNorm.bias"),
            }
        },
    }

    def attn(pre):
        return {
            "q": {"kernel": _heads(g(f"{pre}.self.query.weight"), heads),
                  "bias": _heads_bias(g(f"{pre}.self.query.bias"), heads)},
            "k": {"kernel": _heads(g(f"{pre}.self.key.weight"), heads),
                  "bias": _heads_bias(g(f"{pre}.self.key.bias"), heads)},
            "v": {"kernel": _heads(g(f"{pre}.self.value.weight"), heads),
                  "bias": _heads_bias(g(f"{pre}.self.value.bias"), heads)},
            "out": {
                "kernel": g(f"{pre}.output.dense.weight").T.reshape(
                    heads, cfg.hidden_size // heads, cfg.hidden_size),
                "bias": g(f"{pre}.output.dense.bias"),
            },
        }

    def ln_of(name):
        return {"LayerNorm_0": {"scale": g(f"{name}.weight"), "bias": g(f"{name}.bias")}}

    for i in range(cfg.num_layers):
        pre = f"bert.encoder.layer.{i}"
        layer = {
            "self_attn": attn(f"{pre}.attention"),
            "self_norm": ln_of(f"{pre}.attention.output.LayerNorm"),
            "mlp_query": {
                "fc1": _lin(sd, f"{prefix}{pre}.intermediate_query.dense"),
                "fc2": _lin(sd, f"{prefix}{pre}.output_query.dense"),
            },
            "ffn_norm_query": ln_of(f"{pre}.output_query.LayerNorm"),
            "mlp_text": {
                "fc1": _lin(sd, f"{prefix}{pre}.intermediate.dense"),
                "fc2": _lin(sd, f"{prefix}{pre}.output.dense"),
            },
            "ffn_norm_text": ln_of(f"{pre}.output.LayerNorm"),
        }
        if i % cfg.cross_attention_freq == 0:
            layer["cross_attn"] = attn(f"{pre}.crossattention")
            layer["cross_norm"] = ln_of(f"{pre}.crossattention.output.LayerNorm")
        params[f"layer_{i}"] = layer
    return params


def convert_qformer_bundle(sd: dict, cfg, modality: str) -> dict:
    """Route a ``{modality}_*`` checkpoint (``video_qformer.pth`` etc.)
    into the assembly's four per-modality subtrees, as the reference's
    ``init_Qformer``/``init_ln``/``init_vicuna_projection`` filter by
    prefix; what the checkpoint lacks is left out."""
    qf_prefix = f"{modality}_Qformer."
    qf_sd = {k[len(qf_prefix):]: v for k, v in sd.items() if k.startswith(qf_prefix)}
    out = {}
    if qf_sd:
        out[f"{modality}_qformer"] = convert_qformer(qf_sd, cfg)
    if f"{modality}_query_tokens" in sd:
        out[f"{modality}_query_tokens"] = sd[f"{modality}_query_tokens"]
    # LN routing: "{modality}_ln", with the video branch also accepting
    # "ln_vision": the reference maps load_ln_type "vision" to that name
    # (models/xinstructblip.py:694-696), and the Salesforce video bundle
    # stores its LN under it.
    ln_key = f"{modality}_ln"
    if f"{ln_key}.weight" not in sd and modality == "video" and "ln_vision.weight" in sd:
        ln_key = "ln_vision"
    if f"{ln_key}.weight" in sd:
        out[f"{modality}_ln"] = {"ln": {"LayerNorm_0": {"scale": sd[f"{ln_key}.weight"],
                                                        "bias": sd[f"{ln_key}.bias"]}}}
    proj_key = f"{modality}_llm_proj"
    if f"{proj_key}.weight" in sd:
        out[f"{modality}_proj"] = {"proj": {"kernel": sd[f"{proj_key}.weight"].T,
                                            "bias": sd[f"{proj_key}.bias"]}}
    return out


# ---------------------------------------------------------------------------
# Llama / Vicuna (HF layout)
# ---------------------------------------------------------------------------


def convert_llama_hf(sd: dict, cfg) -> dict:
    """HF llama-family causal-LM state dict → ``LlamaModel`` params.  Rows
    beyond the checkpoint's vocab (the appended [PAD], and the rows of
    ``cfg.vocab_pad_multiple``) are zeros, as ``resize_token_embeddings``
    gives (``models/xinstructblip.py:154``).  A checkpoint without
    ``lm_head.weight`` reuses the embedding (HF ``tie_word_embeddings``).
    Q/k/v biases (the Qwen2 flavour) must agree with
    ``cfg.attention_bias``, either way."""
    has_bias = "model.layers.0.self_attn.q_proj.bias" in sd
    if has_bias and not cfg.attention_bias:
        raise ValueError(
            "checkpoint carries q/k/v biases (Qwen2 flavor) but "
            "cfg.attention_bias is False — set LlamaConfig.attention_bias")
    if cfg.attention_bias and not has_bias:
        raise ValueError(
            "cfg.attention_bias=True but the checkpoint has no q/k/v "
            "biases — wrong decoder flavor for this checkpoint")

    def pad_vocab(w, axis=0):
        if w.shape[axis] < cfg.padded_vocab_size:
            pad = [(0, 0)] * w.ndim
            pad[axis] = (0, cfg.padded_vocab_size - w.shape[axis])
            w = np.pad(w, pad)
        return w

    head_w = sd.get("lm_head.weight", sd["model.embed_tokens.weight"])
    params = {
        "embed_tokens": {"embedding": pad_vocab(sd["model.embed_tokens.weight"])},
        "final_norm": {"scale": sd["model.norm.weight"]},
        "lm_head": {"kernel": pad_vocab(head_w, axis=0).T},
    }

    def proj(pre, name):
        out = {"kernel": sd[f"{pre}.self_attn.{name}.weight"].T}
        if f"{pre}.self_attn.{name}.bias" in sd:
            out["bias"] = sd[f"{pre}.self_attn.{name}.bias"]
        return out

    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}"
        params[f"layer_{i}"] = {
            "input_norm": {"scale": sd[f"{pre}.input_layernorm.weight"]},
            "post_attn_norm": {"scale": sd[f"{pre}.post_attention_layernorm.weight"]},
            "attn": {name: proj(pre, name)
                     for name in ("q_proj", "k_proj", "v_proj", "o_proj")},
            "mlp": {name: {"kernel": sd[f"{pre}.mlp.{name}.weight"].T}
                    for name in ("gate_proj", "up_proj", "down_proj")},
        }
    return params


def quantize_llama_int8(params: dict) -> dict:
    """Float param tree → int8 per-output-channel weights + f32 scales
    (the counterpart of ``load_in_8bit``), the JAX package's numpy
    arithmetic, so leaves and scales are bit-identical to its.  Every
    ``kernel`` under a ``*_proj`` scope becomes ``w_int8`` and ``scale``
    in its place; LoRA, norm and embedding params pass through, and
    ``lm_head`` stays float, as HF's ``get_keys_to_not_convert`` keeps it
    under ``load_in_8bit`` (reference ``models/xinstructblip.py:151``)."""

    def walk(tree: dict, names: tuple) -> dict:
        out = {}
        for k, v in tree.items():
            path = names + (str(k),)
            if isinstance(v, dict):
                out[k] = walk(v, path)
            elif (k == "kernel" and "lm_head" not in path
                  and any(n.endswith("_proj") for n in path)):
                scale = np.abs(v).max(axis=0) / 127.0
                scale = np.where(scale == 0, 1.0, scale)
                out["w_int8"] = np.round(v / scale).astype(np.int8)
                out["scale"] = scale.astype(np.float32)
            else:
                out[k] = v
        return out

    return walk(params, ())


# ---------------------------------------------------------------------------
# BEATs
# ---------------------------------------------------------------------------


def convert_beats(sd: dict, cfg) -> dict:
    """BEATs iter3+ checkpoint → ``BeatsEncoder`` params.

    BEATs keeps one shared relative-attention-bias table on layer 0
    (reused by every layer) and per-layer ``grep_linear`` (head_dim → 8)
    + ``grep_a`` gate parameters; the real file stores ``pos_conv``
    weight-normed, which is folded here."""
    heads = cfg.num_heads
    width = cfg.width
    p = cfg.patch_size

    conv = sd["patch_embedding.weight"]  # (conv_dim, 1, p, p)
    kernel = conv[:, 0].transpose(1, 2, 0).reshape(p * p, cfg.conv_dim)
    params: dict = {
        "patch_embed": {"kernel": kernel},
        "patch_norm": {"LayerNorm_0": _ln(sd, "layer_norm")},
    }
    if "patch_embedding.bias" in sd:
        params["patch_embed"]["bias"] = sd["patch_embedding.bias"]
    else:
        params["patch_embed"]["bias"] = np.zeros(cfg.conv_dim, np.float32)
    if cfg.conv_dim != width and "post_extract_proj.weight" in sd:
        params["post_extract_proj"] = _lin(sd, "post_extract_proj")

    if "encoder.pos_conv.0.weight_v" in sd:
        # torch.nn.utils.weight_norm, dim=2: weight = g * v / ||v|| with the
        # norm over dims (0, 1) per kernel position
        g = sd["encoder.pos_conv.0.weight_g"]
        v = sd["encoder.pos_conv.0.weight_v"]
        norm = np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True))
        w = g * v / np.maximum(norm, 1e-12)
    elif "encoder.pos_conv.0.weight" in sd:
        w = sd["encoder.pos_conv.0.weight"]
    else:
        w = None
    if w is not None:
        # torch conv1d weight (out, in/groups, k) → flax (k, in/groups, out)
        params["pos_conv"] = {
            "kernel": w.transpose(2, 1, 0),
            "bias": sd.get("encoder.pos_conv.0.bias", np.zeros(width, np.float32)),
        }
    if "encoder.layer_norm.weight" in sd:
        params["pre_encoder_norm"] = {"LayerNorm_0": _ln(sd, "encoder.layer_norm")}

    bias_key = "encoder.layers.0.self_attn.relative_attention_bias.weight"
    if bias_key in sd:
        params["rel_pos_bias"] = {"rel_attn_bias": sd[bias_key]}
    for i in range(cfg.depth):
        gate_key = f"encoder.layers.{i}.self_attn.grep_linear.weight"
        if gate_key in sd:
            params[f"gate_{i}"] = {
                "grep_linear": {
                    "kernel": sd[gate_key].T,
                    "bias": sd.get(f"encoder.layers.{i}.self_attn.grep_linear.bias",
                                   np.zeros(8, np.float32)),
                },
                "grep_a": sd.get(f"encoder.layers.{i}.self_attn.grep_a",
                                 np.ones((1, cfg.num_heads, 1, 1), np.float32)
                                 ).reshape(cfg.num_heads),
            }

    for i in range(cfg.depth):
        pre = f"encoder.layers.{i}"
        params[f"block_{i}"] = {
            "attn": {
                "q": {"kernel": _heads(sd[f"{pre}.self_attn.q_proj.weight"], heads),
                      "bias": _heads_bias(sd[f"{pre}.self_attn.q_proj.bias"], heads)},
                "k": {"kernel": _heads(sd[f"{pre}.self_attn.k_proj.weight"], heads),
                      "bias": _heads_bias(sd.get(f"{pre}.self_attn.k_proj.bias",
                                                 np.zeros(width, np.float32)), heads)},
                "v": {"kernel": _heads(sd[f"{pre}.self_attn.v_proj.weight"], heads),
                      "bias": _heads_bias(sd[f"{pre}.self_attn.v_proj.bias"], heads)},
                "out": {
                    "kernel": sd[f"{pre}.self_attn.out_proj.weight"].T.reshape(
                        heads, width // heads, width),
                    "bias": sd[f"{pre}.self_attn.out_proj.bias"],
                },
            },
            "norm1": {"LayerNorm_0": _ln(sd, f"{pre}.self_attn_layer_norm")},
            "mlp": {"fc1": _lin(sd, f"{pre}.fc1"), "fc2": _lin(sd, f"{pre}.fc2")},
            "norm2": {"LayerNorm_0": _ln(sd, f"{pre}.final_layer_norm")},
        }
    return params


# ---------------------------------------------------------------------------
# HF CLIP / SigLIP vision towers and the merged VideoLLaMA2-AV checkpoint
# ---------------------------------------------------------------------------


def _hf_vit_blocks(g, cfg) -> dict:
    """The encoder blocks of an HF CLIP/SigLIP vision tower (separate
    q/k/v with biases, pre-LN) → ``EvaViT`` block params."""
    heads, width = cfg.num_heads, cfg.width
    out = {}
    for i in range(cfg.depth):
        pre = f"encoder.layers.{i}"
        out[f"block_{i}"] = {
            "norm1": {"LayerNorm_0": {"scale": g(f"{pre}.layer_norm1.weight"),
                                      "bias": g(f"{pre}.layer_norm1.bias")}},
            "norm2": {"LayerNorm_0": {"scale": g(f"{pre}.layer_norm2.weight"),
                                      "bias": g(f"{pre}.layer_norm2.bias")}},
            "attn": {
                **{name: {"kernel": _heads(g(f"{pre}.self_attn.{proj}.weight"), heads),
                          "bias": _heads_bias(g(f"{pre}.self_attn.{proj}.bias"), heads)}
                   for name, proj in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"))},
                "out": {"kernel": g(f"{pre}.self_attn.out_proj.weight").T.reshape(
                            heads, width // heads, width),
                        "bias": g(f"{pre}.self_attn.out_proj.bias")},
            },
            "mlp": {"fc1": {"kernel": g(f"{pre}.mlp.fc1.weight").T,
                            "bias": g(f"{pre}.mlp.fc1.bias")},
                    "fc2": {"kernel": g(f"{pre}.mlp.fc2.weight").T,
                            "bias": g(f"{pre}.mlp.fc2.bias")}},
        }
    return out


def convert_clip_vit_hf(sd: dict, cfg, prefix: str = "vision_model.") -> dict:
    """HF ``CLIPVisionModel`` weights → ``EvaViT`` params (class embedding
    and learned positions; the final ``post_layernorm`` is dropped: the
    consumer normalizes)."""
    g = lambda name: sd[f"{prefix}{name}"]
    p, width = cfg.patch_size, cfg.width
    conv = g("embeddings.patch_embedding.weight")  # (D, 3, p, p)
    params = {
        "patch_embed": {
            "kernel": conv.transpose(2, 3, 1, 0).reshape(p * p * 3, width),
            "bias": sd.get(f"{prefix}embeddings.patch_embedding.bias",
                           np.zeros(width, np.float32)),
        },
        "cls_token": g("embeddings.class_embedding").reshape(1, 1, width),
        "pos_embed": g("embeddings.position_embedding.weight")[None],
    }
    params.update(_hf_vit_blocks(g, cfg))
    return params


def convert_siglip_vit_hf(sd: dict, cfg, prefix: str = "vision_model.") -> dict:
    """HF ``SiglipVisionModel`` weights → ``EvaViT`` params (the
    VideoLLaMA2.1 tower): no class embedding (the config must say
    ``use_class_token=False``), positions for the patches only; the final
    ``post_layernorm`` and the attention-pooling ``head`` are dropped."""
    if getattr(cfg, "use_class_token", True):
        raise ValueError(
            "SigLIP towers have no class token — build the ViTConfig with "
            "use_class_token=False (see videollama21_av_config)")
    g = lambda name: sd[f"{prefix}{name}"]
    p, width = cfg.patch_size, cfg.width
    conv = g("embeddings.patch_embedding.weight")  # (D, 3, p, p)
    params = {
        "patch_embed": {"kernel": conv.transpose(2, 3, 1, 0).reshape(p * p * 3, width),
                        "bias": g("embeddings.patch_embedding.bias")},
        "pos_embed": g("embeddings.position_embedding.weight")[None],
    }
    params.update(_hf_vit_blocks(g, cfg))
    return params


def convert_videollama(sd: dict, cfg) -> dict:
    """A merged VideoLLaMA2-AV-style checkpoint → ``VideoLLaMA`` params:

    * ``model.vision_tower.vision_tower.vision_model.*``: a CLIP tower
      when it has ``embeddings.class_embedding``, else a SigLIP tower;
    * ``model.mm_projector.{readout.}{0,2}``: the connector's
      ``proj_in``/``proj_out`` (the projector's conv and downsampling
      keys have no counterpart in the pooling connector and are dropped,
      with a log line);
    * ``model.audio_tower.*``: BEATs; ``model.mm_projector_a.{readout.}
      {0,2}``: ``audio_proj.fc1``/``fc2``;
    * ``model.embed_tokens/layers/norm`` + ``lm_head``: the LLM
      (:func:`convert_llama_hf`; Qwen2's q/k/v biases need
      ``cfg.llm.attention_bias``).

    What the checkpoint lacks is left out."""
    params: dict = {}
    vision_prefix = "model.vision_tower.vision_tower.vision_model."
    if any(k.startswith(vision_prefix) for k in sd):
        if f"{vision_prefix}embeddings.class_embedding" in sd:
            params["vit"] = convert_clip_vit_hf(sd, cfg.vit, prefix=vision_prefix)
        else:
            params["vit"] = convert_siglip_vit_hf(sd, cfg.vit, prefix=vision_prefix)

    audio_prefix = "model.audio_tower."
    audio_sd = {k[len(audio_prefix):]: v for k, v in sd.items() if k.startswith(audio_prefix)}
    if audio_sd:
        params["beats"] = convert_beats(audio_sd, cfg.beats)

    def mlp_pair(prefix, names):
        for base in (f"{prefix}readout.", prefix):
            if f"{base}0.weight" in sd:
                return {names[0]: _lin(sd, f"{base}0"), names[1]: _lin(sd, f"{base}2")}
        return None

    connector = mlp_pair("model.mm_projector.", ("proj_in", "proj_out"))
    if connector:
        params["connector"] = connector
        dropped = [k for k in sd if k.startswith("model.mm_projector.") and ".readout." not in k]
        if dropped:
            logger.info("convert_videollama: dropped %d mm_projector conv/downsample keys "
                        "(pooling connector has no counterpart)", len(dropped))
    audio_proj = mlp_pair("model.mm_projector_a.", ("fc1", "fc2"))
    if audio_proj:
        params["audio_proj"] = audio_proj
    if "model.embed_tokens.weight" in sd:
        params["llm"] = convert_llama_hf(sd, cfg.llm)
    return params


# ---------------------------------------------------------------------------
# Not ported yet
# ---------------------------------------------------------------------------


def quantize_llama_int4(params: dict, group_size: int = 128) -> dict:
    raise NotImplementedError("int4 weights are not ported yet (ROADMAP.md A.2)")


def stack_llm_layers(llm: dict, num_layers: int) -> dict:
    raise NotImplementedError("the scan_layers layout is not ported yet (ROADMAP.md A.2)")


# ---------------------------------------------------------------------------
# Top-level loader
# ---------------------------------------------------------------------------


def load_pretrained_params(model, cfg):
    """Random-init ``model`` from ``cfg.train.seed``, then overlay every
    converted checkpoint whose path ``cfg`` names (empty paths stay
    random), in the JAX package's order: the per-modality Q-Former
    bundles, the BLIP-2 stage-1 fallback, EVA-ViT, BEATs, the LLM
    (quantized to int8 when the config asks).  One artifact is held on
    the host at a time.  Returns ``model``, its parameters in the
    checkpoints' dtypes (cast them with ``cast_params_for_inference``).

    For VideoLLaMA, ``cfg.llm_weights`` names the one merged checkpoint
    (:func:`convert_videollama`; its LLM quantized to int8 when the
    model's config asks), and ``cfg.beats_weights`` may overlay a BEATs
    checkpoint after it."""
    from mraudio_tpu_torch.models.videollama import VideoLLaMA

    llm_cfg = model.cfg.llm if isinstance(model, VideoLLaMA) else cfg.model.llm
    if llm_cfg.quantization == "int4":
        raise NotImplementedError("int4 weights are not ported yet (ROADMAP.md A.2)")
    if llm_cfg.scan_layers:
        raise NotImplementedError("the scan_layers layout is not ported yet (ROADMAP.md A.2)")
    init_random_(model, seed=cfg.train.seed)

    if isinstance(model, VideoLLaMA):
        if cfg.llm_weights:
            converted = convert_videollama(load_torch_state_dict(cfg.llm_weights), model.cfg)
            if llm_cfg.quantization == "int8" and "llm" in converted:
                converted["llm"] = quantize_llama_int8(converted["llm"])
            overlay_jax_params_(model, converted)
            logger.info("loaded VideoLLaMA checkpoint from %s", cfg.llm_weights)
        if cfg.beats_weights:
            overlay_jax_params_(model, {"beats": convert_beats(
                load_torch_state_dict(cfg.beats_weights), model.cfg.beats)})
            logger.info("loaded BEATs weights from %s", cfg.beats_weights)
        return model

    qcfg = cfg.model.qformer

    def llm(sd):
        tree = convert_llama_hf(sd, llm_cfg)
        return quantize_llama_int8(tree) if llm_cfg.quantization == "int8" else tree

    steps = (
        (cfg.video_qformer_weights, "video Q-Former bundle",
         lambda sd: [convert_qformer_bundle(sd, qcfg, "video")]),
        (cfg.audio_qformer_weights, "audio Q-Former bundle",
         lambda sd: [convert_qformer_bundle(sd, qcfg, "audio")]),
        (cfg.blip2_stage1_weights, "BLIP-2 stage-1 weights",
         lambda sd: (convert_qformer_bundle(sd, qcfg, m) for m in cfg.model.modalities)),
        (cfg.vit_weights, "EVA-ViT weights",
         lambda sd: [{"vit": convert_eva_vit(sd, cfg.model.vit)}]),
        (cfg.beats_weights, "BEATs weights",
         lambda sd: [{"beats": convert_beats(sd, cfg.model.beats)}]),
        (cfg.llm_weights, "LLM weights", lambda sd: [{"llm": llm(sd)}]),
    )
    for path, what, convert in steps:
        if path:
            for tree in convert(load_torch_state_dict(path)):
                overlay_jax_params_(model, tree)
            logger.info("loaded %s from %s", what, path)
    return model
