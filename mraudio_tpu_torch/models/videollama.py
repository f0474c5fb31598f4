"""VideoLLaMA-style audio-visual backbone, the second model family (the
JAX package's ``models/videollama.py``).

The reference wraps the external VideoLLaMA2 package as a black box
(``models/videollama.py:1-25``: ``model_init`` + ``mm_infer``).  The JAX
package rebuilds its architecture from its own components, and the port
follows it module for module:

* frames fold into the batch axis through the ViT (EVA-ViT, or a CLIP or
  SigLIP tower in the same module); the class token is dropped when the
  tower has one;
* :class:`STCConnector` pools space ``spatial_pool``² and time
  ``temporal_stride``x, then ``proj_in`` → exact GELU → ``proj_out``, so
  60 frames of 256 patch tokens become 960 LLM tokens;
* :class:`AudioProjector` mean-pools each chunk's BEATs tokens and
  projects them (one LLM token per chunk);
* the LLM (Vicuna, or Qwen2 with grouped-query attention and q/k/v
  biases) prefills ``[video tokens][audio tokens][left-padded prompt]``
  and decodes greedily, or with lookup self-speculation
  (``lookup_spec``), from the prompt's token ids.

The connector and the projector compute in bf16 whatever the config's
dtypes, as in the JAX package, whose bf16 GELU :func:`gelu_bf16` writes
out.  Training trains the LoRA adapters, the
connector and the audio projector (:attr:`VideoLLaMA.TRAINABLE_PATTERN`):
the shifted cross entropy with HF's -100 ignore over ``[prefix][prompt +
target]``, the prefix carrying no loss.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from mraudio_tpu_torch.config import (AudioFrontendConfig, BeatsConfig, LlamaConfig, LoraConfig,
                                      ViTConfig, _ConfigBase)
from mraudio_tpu_torch.device import resolve_device, torch_dtype
from mraudio_tpu_torch.infer.generate import greedy_generate, lookup_generate
from mraudio_tpu_torch.models.beats import BeatsEncoder
from mraudio_tpu_torch.models.eva_vit import EvaViT
from mraudio_tpu_torch.models.layers import Dense, positions_from_mask
from mraudio_tpu_torch.models.llama import LlamaModel
from mraudio_tpu_torch.models.xinstructblip import XInstructBLIP
from mraudio_tpu_torch.ops.fbank import beats_frontend
from mraudio_tpu_torch.ops.image import augment_and_normalize, normalize_frames
from mraudio_tpu_torch.text.tokenizer import ByteTokenizer


@dataclass(frozen=True)
class VideoLLaMAConfig(_ConfigBase):
    vit: ViTConfig = field(default_factory=ViTConfig)
    beats: BeatsConfig = field(default_factory=BeatsConfig)
    llm: LlamaConfig = field(default_factory=LlamaConfig)
    lora: LoraConfig = field(default_factory=lambda: LoraConfig(enabled=False))
    spatial_pool: int = 2         # 2x2 spatial token pooling
    temporal_stride: int = 4      # frames pooled per connector step
    max_txt_len: int = 128
    max_output_txt_len: int = 64
    max_new_tokens: int = 64
    system_prompt: str = ""
    # Vision-tower normalization: the CLIP constants; VideoLLaMA2.1's
    # SigLIP tower normalizes with 0.5 / 0.5.
    image_mean: tuple = (0.48145466, 0.4578275, 0.40821073)
    image_std: tuple = (0.26862954, 0.26130258, 0.27577711)
    # Lookup self-speculation width (0/1 = plain greedy); greedy's tokens.
    lookup_spec: int = 0


def tiny_videollama_config() -> VideoLLaMAConfig:
    return VideoLLaMAConfig(
        vit=ViTConfig(image_size=28, patch_size=14, width=32, depth=2, num_heads=2, mlp_dim=64),
        beats=BeatsConfig(num_mel_bins=16, patch_size=4, patch_stride=4, conv_dim=16,
                          width=32, depth=2, num_heads=2, mlp_dim=64,
                          conv_pos_kernel=8, conv_pos_groups=2,
                          rel_pos_buckets=16, rel_pos_max_distance=32),
        llm=LlamaConfig(vocab_size=260, hidden_size=64, num_layers=2, num_heads=4,
                        num_kv_heads=4, intermediate_size=128),
        spatial_pool=1,
        temporal_stride=2,
        max_txt_len=48,
        max_output_txt_len=24,
        max_new_tokens=8,
    )


def videollama21_av_config(n_frms: int = 60) -> VideoLLaMAConfig:
    """The VideoLLaMA2.1-7B-AV checkpoint's architecture: a SigLIP-so400m
    tower (384², patch 14, no class token, width 1152, 27 blocks,
    gelu_tanh MLPs, 0.5 / 0.5 normalization), a Qwen2-7B decoder (hidden
    3584, 28 query heads over 4 KV heads, intermediate 18944, q/k/v
    biases, rope theta 1e6, vocab 152064, bf16 weights), BEATs, and the
    STC connector (the 27-wide patch grid is odd, so no spatial pooling)."""
    grid = 384 // 14
    return VideoLLaMAConfig(
        vit=ViTConfig(image_size=384, patch_size=14, width=1152, depth=27, num_heads=16,
                      mlp_dim=4304, use_class_token=False, mlp_act="gelu_tanh"),
        beats=BeatsConfig(),
        llm=LlamaConfig(vocab_size=152064, hidden_size=3584, num_layers=28, num_heads=28,
                        num_kv_heads=4, intermediate_size=18944, attention_bias=True,
                        rope_theta=1e6, rms_norm_eps=1e-6, max_seq_len=32768),
        spatial_pool=1 if grid % 2 else 2,
        temporal_stride=next(d for d in (4, 2, 1) if n_frms % d == 0),
        image_mean=(0.5, 0.5, 0.5),
        image_std=(0.5, 0.5, 0.5),
    )


def videollama_config_from(m, n_frms: int) -> VideoLLaMAConfig:
    """A :class:`VideoLLaMAConfig` from an assembly config (the vit, beats,
    llm and lora knobs are shared, so ``--model-size`` and config files
    apply to both backbones), with connector strides that fit the patch
    grid and the frame count."""
    grid = m.vit.image_size // m.vit.patch_size
    return VideoLLaMAConfig(
        vit=m.vit, beats=m.beats, llm=m.llm, lora=m.lora,
        spatial_pool=2 if grid % 2 == 0 else 1,
        temporal_stride=next(d for d in (4, 2, 1) if n_frms % d == 0),
        max_txt_len=m.max_txt_len, max_output_txt_len=m.max_output_txt_len,
        max_new_tokens=m.max_new_tokens,
    )


def gelu_bf16(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU of a bf16 tensor with the JAX package's bf16 arithmetic
    (``jax.nn.gelu(approximate=False)`` as XLA computes it): ``0.5 · x ·
    erfc(-x · sqrt(1/2))`` with sqrt(1/2) rounded to bf16, the erfc taken
    in f32 and rounded to bf16, and the product in f32, rounded once."""
    xf = x.float()
    half_sqrt = torch.tensor(0.5 ** 0.5, dtype=torch.bfloat16).item()
    erfc = torch.erfc(-xf * half_sqrt).to(torch.bfloat16).float()
    return (0.5 * xf * erfc).to(torch.bfloat16)


def _mean(x: torch.Tensor, dim) -> torch.Tensor:
    """``jnp.mean``: low-precision inputs are averaged in f32 and rounded
    back to their dtype."""
    return x.float().mean(dim=dim).to(x.dtype)


class STCConnector(nn.Module):
    """Spatial-temporal connector: pool space and time, then a two-layer
    MLP to the LLM width, in bf16."""

    def __init__(self, in_features: int, out_features: int, spatial_pool: int,
                 temporal_stride: int):
        super().__init__()
        self.spatial_pool, self.temporal_stride = spatial_pool, temporal_stride
        self.proj_in = Dense(in_features, out_features, True, torch.bfloat16)
        self.proj_out = Dense(out_features, out_features, True, torch.bfloat16)

    def forward(self, frame_tokens: torch.Tensor) -> torch.Tensor:
        """(B, T, P, D) patch tokens → (B, T // ts · P // sp², out)."""
        b, t, p, d = frame_tokens.shape
        g = int(round(p ** 0.5))
        sp, ts = self.spatial_pool, self.temporal_stride
        x = _mean(frame_tokens.reshape(b, t, g // sp, sp, g // sp, sp, d), (3, 5))
        x = _mean(x.reshape(b, t // ts, ts, g // sp, g // sp, d), 2)
        x = x.reshape(b, -1, d)
        return self.proj_out(gelu_bf16(self.proj_in(x)))


class AudioProjector(nn.Module):
    """(B, T, S, D) BEATs tokens → (B, T, out): the mean over each chunk's
    tokens, then a two-layer MLP, in bf16."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.fc1 = Dense(in_features, out_features, True, torch.bfloat16)
        self.fc2 = Dense(out_features, out_features, True, torch.bfloat16)

    def forward(self, chunk_tokens: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu_bf16(self.fc1(_mean(chunk_tokens, 2))))


class VideoLLaMA(nn.Module):
    """The second backbone behind the contract of :class:`XInstructBLIP`:
    ``generate_submit``/``generate_finalize``/``generate``, ``loss_arrays``
    and ``_loss_fn``, ``device_inputs`` and ``device_arrays``."""

    # LoRA adapters, the connector and the audio projector train; the
    # towers and the LLM's base stay frozen.
    TRAINABLE_PATTERN = r"(lora_a|lora_b|connector|audio_proj)"

    def __init__(self, cfg: VideoLLaMAConfig, audio_cfg: AudioFrontendConfig | None = None,
                 llm_tokenizer=None, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.audio_cfg = audio_cfg or AudioFrontendConfig()
        self.llm_tokenizer = llm_tokenizer or ByteTokenizer(cfg.llm.vocab_size)
        d = cfg.llm.hidden_size
        with torch.device(resolve_device(device)):
            self.vit = EvaViT(cfg.vit)
            self.beats = BeatsEncoder(cfg.beats)
            self.llm = LlamaModel(cfg.llm, cfg.lora if cfg.lora.enabled else None)
            self.connector = STCConnector(cfg.vit.width, d, cfg.spatial_pool,
                                          cfg.temporal_stride)
            self.audio_proj = AudioProjector(cfg.beats.width, d)

    @property
    def device(self) -> torch.device:
        return self.llm.final_norm.scale.device

    # ------------------------------------------------------------------

    def _prefix(self, video_u8, audio_wave, n_frms: int, crop_params=None):
        """Video and audio → (prefix (B, S_prefix, D), mask (B, S_prefix)):
        the connector's tokens, then one token per audio chunk."""
        cfg = self.cfg
        if crop_params is not None:
            frames = augment_and_normalize(video_u8, crop_params, cfg.vit.image_size,
                                           dtype=torch_dtype(cfg.vit.dtype))
        else:
            frames = normalize_frames(video_u8, dtype=torch_dtype(cfg.vit.dtype),
                                      mean=cfg.image_mean, std=cfg.image_std)
        b, t = frames.shape[:2]
        feats = self.vit(frames.reshape((b * t,) + frames.shape[2:]))
        patch = feats[:, 1:] if cfg.vit.use_class_token else feats
        video_tokens = self.connector(patch.reshape(b, t, patch.shape[1], cfg.vit.width))

        fbank = beats_frontend(audio_wave, self.audio_cfg, n_frms)
        audio_feats = self.beats(fbank.reshape((b * n_frms,) + fbank.shape[2:]))
        audio_tokens = self.audio_proj(audio_feats.reshape(b, n_frms, -1, cfg.beats.width))

        prefix = torch.cat([video_tokens, audio_tokens], dim=1)
        return prefix, torch.ones(prefix.shape[:2], dtype=torch.int32, device=prefix.device)

    @staticmethod
    def _join(prefix, pmask, text_emb, text_mask):
        """``[prefix][text]`` in the promoted dtype (``jnp.concatenate``'s
        rule: a bf16 prefix before f32 text embeddings is widened)."""
        dt = torch.promote_types(prefix.dtype, text_emb.dtype)
        embeds = torch.cat([prefix.to(dt), text_emb.to(dt)], dim=1)
        return embeds, torch.cat([pmask, text_mask.to(torch.int32)], dim=1)

    # ------------------------------------------------------------------

    def device_inputs(self, batch) -> tuple:
        """Copy the batch's video and audio arrays to the device."""
        dev = self.device
        return (torch.from_numpy(np.asarray(batch.video)).to(dev, non_blocking=True),
                torch.from_numpy(np.asarray(batch.audio)).to(dev, non_blocking=True))

    @torch.inference_mode()
    def generate_submit(self, params=None, batch=None, device_inputs=None,
                        stats: dict | None = None):
        """Encoders, connector, prefill and the decode loop; returns the
        (B, max_new_tokens) tokens on the device.  ``stats``, if given,
        receives ``encode_s`` and ``prefix_len`` plus what the decoder
        records; the encoding runs inside a profiler span named
        ``encode``.  ``params`` must be None: the weights live in the
        module."""
        if params is not None:
            raise ValueError("the port's weights live in the module; pass params=None")
        cfg = self.cfg
        dev = self.device
        t0 = time.perf_counter()
        with record_function("encode"):
            n_frms = batch.timestamps.shape[1]
            video_dev, audio_dev = device_inputs or self.device_inputs(batch)
            prefix, pmask = self._prefix(video_dev, audio_dev, n_frms)
            enc = self.llm_tokenizer([cfg.system_prompt + p.strip() for p in batch.text_input],
                                     max_length=cfg.max_txt_len, padding_side="left",
                                     truncation_side="left")
            ids = torch.from_numpy(np.asarray(enc.input_ids)).to(dev)
            prompt_mask = torch.from_numpy(np.asarray(enc.attention_mask)).to(dev)
            embeds, mask = self._join(prefix, pmask, self.llm.embed(ids), prompt_mask)
            if stats is not None:
                if embeds.is_cuda:
                    torch.cuda.synchronize(embeds.device)
                stats["encode_s"] = time.perf_counter() - t0
                stats["prefix_len"] = embeds.shape[1]
        eos = self.llm_tokenizer.eos_token_id
        if cfg.lookup_spec >= 2:
            # prompt-lookup hints: the prompt's token ids
            return lookup_generate(self.llm, embeds, mask, cfg.max_new_tokens, eos,
                                   spec_width=cfg.lookup_spec, hint_ids=ids,
                                   hint_mask=prompt_mask, stats=stats)
        return greedy_generate(self.llm, embeds, mask, cfg.max_new_tokens, eos, stats=stats)

    def generate_finalize(self, pending, return_saliency: bool = False):
        """Decode a :meth:`generate_submit` result to strings (with
        ``return_saliency``, ``(texts, None)``: this backbone has no
        saliency head)."""
        tokens = pending.cpu().numpy().copy()
        tokens[tokens == 0] = self.llm_tokenizer.eos_token_id
        texts = [t.strip() for t in self.llm_tokenizer.batch_decode(tokens)]
        return (texts, None) if return_saliency else texts

    def generate(self, params=None, batch=None, device_inputs=None,
                 stats: dict | None = None) -> list:
        return self.generate_finalize(
            self.generate_submit(params, batch, device_inputs, stats=stats))

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------

    # the mean token CE over the targets, 512 positions at a time
    _chunked_ce = XInstructBLIP._chunked_ce
    _global_count = XInstructBLIP._global_count

    def _loss_fn(self, video_u8, audio_wave, concat_ids, concat_mask, labels,
                 crop_params=None, dropout_key=None, *, n_frms: int):
        """The training forward → scalar loss: the prefix (with the crop and
        flip of ``crop_params``), the prompt and target, the decoder's
        training forward and the shifted CE.  ``dropout_key`` turns LoRA
        dropout on."""
        prefix, pmask = self._prefix(video_u8, audio_wave, n_frms, crop_params=crop_params)
        embeds, mask = self._join(prefix, pmask, self.llm.embed(concat_ids), concat_mask)
        full_labels = torch.cat([torch.full(pmask.shape, -100, dtype=torch.int64,
                                            device=mask.device), labels.long()], dim=1)
        s = embeds.shape[1]
        causal = torch.ones((s, s), dtype=torch.bool, device=mask.device).tril()[None, None]
        attend = causal & (mask[:, None, None, :] > 0)
        hidden, _ = self.llm(embeds, attend, positions_from_mask(mask), kv_valid=mask,
                             causal=True, return_hidden=True, dropout_key=dropout_key)
        return self._chunked_ce(hidden[:, :-1], full_labels[:, 1:])

    def loss_arrays(self, batch) -> tuple:
        """Host-side text prep → the host arrays :meth:`_loss_fn` takes:
        video, audio, ``[prompt with BOS][target + EOS]`` ids and mask,
        and the labels (-100 on the prompt and the padding)."""
        cfg = self.cfg
        tok = self.llm_tokenizer
        total = cfg.max_txt_len + cfg.max_output_txt_len
        b = len(batch.text_input)
        concat_ids = np.full((b, total), tok.pad_token_id, np.int32)
        concat_mask = np.zeros((b, total), np.int32)
        labels = np.full((b, total), -100, np.int32)
        for i, (inp, out) in enumerate(zip(batch.text_input, batch.text_output)):
            in_ids = tok.encode(cfg.system_prompt + inp, add_special_tokens=True)[
                -cfg.max_txt_len:]
            out_ids = tok.encode(out, add_special_tokens=False)[: cfg.max_output_txt_len - 1]
            seq = (in_ids + out_ids + [tok.eos_token_id])[:total]
            concat_ids[i, : len(seq)] = seq
            concat_mask[i, : len(seq)] = 1
            labels[i, : len(seq)] = seq
            labels[i, : min(len(in_ids), total)] = -100
        return (np.asarray(batch.video), np.asarray(batch.audio), concat_ids, concat_mask,
                labels)

    device_arrays = XInstructBLIP.device_arrays

    def loss(self, params=None, batch=None, crop_params=None, dropout_key=None) -> torch.Tensor:
        """Training forward → scalar loss.  ``crop_params`` (B, 5) applies
        the train-time crop and flip (``ops/image.py::sample_crop_params``)."""
        if params is not None:
            raise ValueError("the port's weights live in the module; pass params=None")
        arrays = self.device_arrays(self.loss_arrays(batch))
        crop = None if crop_params is None else torch.as_tensor(crop_params).to(self.device)
        return self._loss_fn(*arrays, crop_params=crop, dropout_key=dropout_key,
                             n_frms=batch.timestamps.shape[1])
