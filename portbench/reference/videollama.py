"""The VideoLLaMA backbone in plain float32, one clip at a time.

Per clip: frames normalized with the configuration's mean and std
through the ViT (its class token dropped, when it has one); the patch
tokens pooled ``spatial_pool``² in space and ``temporal_stride`` frames
in time, then the connector's two dense layers with an exact GELU; each
fbank chunk through BEATs, mean-pooled over its tokens and projected
the same way (one token per chunk).  The decoder reads, unpadded,
``[video tokens][audio tokens][system prompt + stripped prompt, its last
max_txt_len bytes]`` and then the served tokens.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import common
from portbench.reference.common import Weights


def prefix_embeds(w: Weights, model: dict, audio: dict, clip: dict) -> torch.Tensor:
    vit_cfg = model["vit"]
    frames = common.normalize(clip["frames"], model["image_mean"], model["image_std"])
    feats = common.vit(w.sub("vit."), frames, vit_cfg)
    if vit_cfg["use_class_token"]:
        feats = feats[:, 1:]
    t, p, d = feats.shape
    g, sp, ts = int(round(p ** 0.5)), model["spatial_pool"], model["temporal_stride"]
    x = feats.reshape(t, g // sp, sp, g // sp, sp, d).mean(dim=(2, 4))
    x = x.reshape(t // ts, ts, g // sp, g // sp, d).mean(1).reshape(-1, d)
    video = common.dense(w.sub("connector.proj_out."),
                         F.gelu(common.dense(w.sub("connector.proj_in."), x)))

    n_frms = clip["frames"].shape[0]
    chunks = common.fbank_chunks(clip["wave"], audio, n_frms)
    pooled = common.beats(w.sub("beats."), chunks, model["beats"]).mean(1)
    audio_tokens = common.dense(w.sub("audio_proj.fc2."),
                                F.gelu(common.dense(w.sub("audio_proj.fc1."), pooled)))
    prompt = common.byte_ids(model["system_prompt"] + clip["prompt"].strip())
    text = common.embed(w.sub("llm."), prompt[-model["max_txt_len"]:])
    return torch.cat([video, audio_tokens, text])


def served_logits(w: Weights, model: dict, audio: dict, clip: dict, served: list) -> torch.Tensor:
    prefix = prefix_embeds(w, model, audio, clip)
    llm = w.sub("llm.")
    seq = torch.cat([prefix, common.embed(llm, served[:-1])]) if len(served) > 1 else prefix
    at = torch.arange(prefix.shape[0] - 1, prefix.shape[0] - 1 + len(served), device=seq.device)
    lora = model["lora"]
    scale = lora["alpha"] / lora["rank"] if lora["enabled"] else 0.0
    logits = common.decoder_logits(llm, seq, at, model["llm"], lora_scale=scale)
    return logits[:, :model["llm"]["vocab_size"]]
