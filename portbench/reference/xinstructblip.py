"""The X-InstructBLIP assembly in plain float32, one clip at a time.

Per clip: frames normalized with the CLIP constants through the ViT and
``video_ln``; the waveform's fbank chunks through BEATs and
``audio_ln``; each modality's learned queries and the instruction text
through its Q-Former, then its projection to the decoder width.  The
decoder reads, unpadded, per frame ``[" video: " with BOS][video
queries][" audio: " with BOS][audio queries][" <t> "]``, then
``"<duration> "`` and the stripped prompt (its last ``max_txt_len``
bytes), then the served tokens, and returns the logits that predict each
served token.  The program's static padding is masked there and its
positions count only real tokens, so the unpadded sequence is the same
computation.
"""

from __future__ import annotations

import torch

from portbench.reference import common
from portbench.reference.common import Weights

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _timestamp_text(ts, duration, time_format: str) -> str:
    if time_format != "seconds_integers":
        raise ValueError(f"the reference renders seconds_integers only, not {time_format!r}")
    return f" {int(ts)} "


def prefix_embeds(w: Weights, model: dict, audio: dict, clip: dict) -> torch.Tensor:
    """(S, D) float32 decoder inputs of one clip (``clip``: ``frames``
    uint8 (T, H, W, 3) and ``wave`` int16 (N,) tensors on the device,
    ``timestamps``, ``duration``, ``prompt``)."""
    n_frms = clip["frames"].shape[0]
    q = model["qformer"]["num_query_tokens"]
    qformer_ids = torch.tensor(common.byte_ids(clip["prompt"], bos=True)[-model["max_txt_len"]:],
                               device=clip["frames"].device)
    tokens = {}
    if "video" in model["modalities"]:
        feats = common.vit(w.sub("vit."), common.normalize(clip["frames"], CLIP_MEAN, CLIP_STD),
                           model["vit"])
        feats = common.layer_norm(w.sub("video_ln.ln."), feats, 1e-5)
        queries = w("video_query_tokens").expand(n_frms, q, -1)
        out = common.qformer(w.sub("video_qformer."), queries, qformer_ids, feats,
                             model["qformer"])
        tokens["video"] = common.dense(w.sub("video_proj.proj."), out)
    if "audio" in model["modalities"]:
        chunks = common.fbank_chunks(clip["wave"], audio, n_frms)
        feats = common.layer_norm(w.sub("audio_ln.ln."), common.beats(w.sub("beats."), chunks,
                                                                      model["beats"]), 1e-5)
        queries = w("audio_query_tokens").expand(n_frms, q, -1)
        out = common.qformer(w.sub("audio_qformer."), queries, qformer_ids, feats,
                             model["qformer"])
        tokens["audio"] = common.dense(w.sub("audio_proj.proj."), out)

    llm = w.sub("llm.")
    parts = []
    for t in range(n_frms):
        for m in ("video", "audio"):
            if m in tokens:
                parts += [common.embed(llm, common.byte_ids(f" {m}: ", bos=True)), tokens[m][t]]
        if model["interleave_seconds"]:
            ids = common.byte_ids(_timestamp_text(clip["timestamps"][t], clip["duration"],
                                                  model["time_format"]))
            if len(ids) > model["tokens_per_timestamp"]:
                raise ValueError("timestamp rendering exceeds its token budget")
            parts.append(common.embed(llm, ids))
    parts.append(common.embed(llm, common.byte_ids(f"{clip['duration']} ")))
    parts.append(common.embed(llm, common.byte_ids(clip["prompt"].strip())[-model["max_txt_len"]:]))
    return torch.cat(parts)


def served_logits(w: Weights, model: dict, audio: dict, clip: dict, served: list) -> torch.Tensor:
    """(len(served), V) float32 logits, row j predicting ``served[j]``
    from the prefix and ``served[:j]``."""
    prefix = prefix_embeds(w, model, audio, clip)
    llm = w.sub("llm.")
    seq = torch.cat([prefix, common.embed(llm, served[:-1])]) if len(served) > 1 else prefix
    at = torch.arange(prefix.shape[0] - 1, prefix.shape[0] - 1 + len(served), device=seq.device)
    lora = model["lora"]
    scale = lora["alpha"] / lora["rank"] if lora["enabled"] else 0.0
    logits = common.decoder_logits(llm, seq, at, model["llm"], lora_scale=scale)
    return logits[:, :model["llm"]["vocab_size"]]
