"""X-InstructBLIP assembly: frozen encoders → Q-Formers → interleaved
LLM sequence → span text, and the LoRA training loss.

Per frame the interleave is ``[" video: "][Q video tokens][" audio: "]
[Q audio tokens][" t "]``, then ``[duration][prompt]``, with static
per-segment token budgets whose padding is masked (mask-derived
positions make it equivalent to dynamic padding).  Frames and audio
chunks fold into the batch axis; ``encode_clips_per_pass`` clips go
through the encoders per pass.

The decoder is greedy, grammar-constrained with forced-token speculation
(``constrained_decoding``) or lookup self-speculation (``lookup_spec``);
video arrives as RGB or on the yuv420 wire (``video_wire``).  With
``saliency_head`` a per-frame score comes out of the same encoder pass.

Training (:meth:`XInstructBLIP._loss_fn`): the train-time crop and flip,
the interleaved prefix followed by the spliced prompt and target, the
decoder's training forward, and the shifted cross entropy with HF's -100
ignore, computed 512 positions at a time (the f32 logits of the whole
sequence would take GBs), plus the saliency head's BCE.
"""

from __future__ import annotations

import ast
import dataclasses
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from mraudio_tpu_torch.config import AudioFrontendConfig, XInstructBLIPConfig
from mraudio_tpu_torch.device import resolve_device, torch_dtype
from mraudio_tpu_torch.infer.generate import grammar_generate, greedy_generate, lookup_generate
from mraudio_tpu_torch.models.beats import BeatsEncoder
from mraudio_tpu_torch.models.eva_vit import EvaViT
from mraudio_tpu_torch.models.layers import (Dense, LayerNormFp32, _empty, gelu_exact,
                                             positions_from_mask)
from mraudio_tpu_torch.models.llama import LlamaModel
from mraudio_tpu_torch.models.qformer import QFormer
from mraudio_tpu_torch.ops.fbank import beats_frontend
from mraudio_tpu_torch.ops.image import (augment_and_normalize, normalize_frames, rgb_to_yuv420,
                                         yuv420_to_rgb)
from mraudio_tpu_torch.parallel import comm
from mraudio_tpu_torch.text.prompts import MODALITY_CUES
from mraudio_tpu_torch.text.tokenizer import ByteTokenizer


class _Ln(nn.Module):
    """Post-encoder fp32 LayerNorm (``video_ln``/``audio_ln``)."""

    def __init__(self, features: int):
        super().__init__()
        self.ln = LayerNormFp32(features, 1e-5)

    def forward(self, x):
        return self.ln(x)


class _Proj(nn.Module):
    """Q-Former → LLM projection; bf16 whatever the config's dtypes, as
    in the JAX package."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.proj = Dense(in_features, features, True, torch.bfloat16)

    def forward(self, x):
        return self.proj(x)


class _SaliencyHead(nn.Module):
    """Per-frame saliency scores from the video query tokens, in f32:
    (B, T, Q, D) → mean over the queries → Dense(256) → GELU → Dense(1)
    → (B, T)."""

    def __init__(self, features: int):
        super().__init__()
        self.fc1 = Dense(features, 256, True, torch.float32)
        self.fc2 = Dense(256, 1, True, torch.float32)

    def forward(self, video_tokens):
        # the mean is taken in f32 and rounded to the tokens' dtype, as jnp.mean
        pooled = video_tokens.float().mean(dim=2).to(video_tokens.dtype).float()
        return self.fc2(gelu_exact(self.fc1(pooled)))[..., 0]


def _render_timestamps(row, duration, time_format: str) -> list:
    if time_format == "seconds_integers":
        return [int(ts) for ts in row]
    if time_format == "relative_integers":
        return [int(round(float(ts) / duration, 2) * 100) for ts in row]
    if time_format == "seconds_floats":
        return [round(float(ts), 2) for ts in row]
    if time_format == "relative_floats":
        return [round(float(ts) / duration, 2) for ts in row]
    if time_format == "framenumbers":
        return list(range(len(row)))
    raise ValueError(f"unknown time_format {time_format!r}")


@dataclasses.dataclass
class TextBatch:
    """Host-tokenized text chunks with static shapes."""

    qformer_ids: np.ndarray       # (B, Lq)
    qformer_mask: np.ndarray
    ts_ids: np.ndarray            # (B, T, Kts)
    ts_mask: np.ndarray
    dur_ids: np.ndarray           # (B, Kd)
    dur_mask: np.ndarray
    prompt_ids: np.ndarray        # (B, Lp), left-padded at generate
    prompt_mask: np.ndarray
    concat_ids: Optional[np.ndarray] = None    # (B, Lc) train: prompt + target spliced
    concat_mask: Optional[np.ndarray] = None
    labels: Optional[np.ndarray] = None        # (B, Lc), -100 where no loss


@dataclasses.dataclass
class GenerateBatch:
    """What ``generate`` reads from a batch (the JAX package's data
    ``Batch`` has the same fields)."""

    video: np.ndarray             # (B, T, H, W, 3) uint8, or (B, T, H*3//2, W) I420
    audio: np.ndarray             # (B, N) int16 (or float in [-1, 1])
    timestamps: np.ndarray        # (B, T) int seconds
    duration: list
    text_input: list


class XInstructBLIP(nn.Module):
    """The module set plus host tokenization; ``generate`` runs the whole
    inference path on ``device``, ``_loss_fn`` the training forward."""

    # What trains (regex on the flat flax name): the LoRA adapters, and the
    # saliency head when there is one.
    TRAINABLE_PATTERN = r"(lora_a|lora_b|saliency_head)"
    # Parameter scopes that only the encoder pass reads: with nothing
    # trainable under them the trainer encodes without gradients.
    ENCODER_PARAM_KEYS = (
        "vit", "beats", "video_ln", "audio_ln", "video_qformer", "audio_qformer",
        "video_query_tokens", "audio_query_tokens", "video_proj", "audio_proj",
    )

    def __init__(self, cfg: XInstructBLIPConfig, audio_cfg: AudioFrontendConfig | None = None,
                 llm_tokenizer=None, qformer_tokenizer=None, device="cuda"):
        super().__init__()
        unknown = [m for m in cfg.modalities if m not in ("audio", "video")]
        if unknown:
            raise ValueError(f"modalities {unknown} have no code path; use audio/video")
        self.cfg = cfg
        self.audio_cfg = audio_cfg or AudioFrontendConfig()
        self.llm_tokenizer = llm_tokenizer or ByteTokenizer(cfg.llm.vocab_size)
        self.qformer_tokenizer = qformer_tokenizer or ByteTokenizer(cfg.qformer.vocab_size)
        dev = resolve_device(device)
        q, h = cfg.qformer.num_query_tokens, cfg.qformer.hidden_size
        with torch.device(dev):
            self.vit = EvaViT(cfg.vit)
            self.beats = BeatsEncoder(cfg.beats)
            self.video_ln = _Ln(cfg.vit.width)
            self.audio_ln = _Ln(cfg.beats.width)
            self.video_qformer = QFormer(cfg.qformer, cfg.vit.width)
            self.audio_qformer = QFormer(cfg.qformer, cfg.beats.width)
            self.video_query_tokens = _empty(1, q, h)
            self.audio_query_tokens = _empty(1, q, h)
            self.video_proj = _Proj(h, cfg.llm.hidden_size)
            self.audio_proj = _Proj(h, cfg.llm.hidden_size)
            self.llm = LlamaModel(cfg.llm, cfg.lora if cfg.lora.enabled else None)
            if cfg.saliency_head:
                self.saliency_head = _SaliencyHead(cfg.llm.hidden_size)
        # Per-frame modality cues start with BOS, as the reference's
        # tokenizer call does by default.
        self.cue_ids = {
            m: np.asarray(self.llm_tokenizer.encode(MODALITY_CUES[m], add_special_tokens=True),
                          np.int32)
            for m in ("video", "audio")
        }

    @property
    def device(self) -> torch.device:
        return self.llm.final_norm.scale.device

    # ------------------------------------------------------------------
    # Host tokenization
    # ------------------------------------------------------------------

    def prepare_text(self, text_input: list, timestamps: np.ndarray, duration: list,
                     text_output: list | None = None) -> TextBatch:
        """The batch's text, tokenized to static shapes.  With
        ``text_output`` (training) the prompt and the target are spliced
        into ``concat_ids`` with ``labels``; otherwise the prompt is left-
        padded for generation."""
        cfg = self.cfg
        b, t = timestamps.shape
        q_enc = self.qformer_tokenizer(
            text_input, max_length=cfg.max_txt_len,
            padding_side="right", truncation_side="left", add_special_tokens=True,
        )
        flat_ts = [
            f" {ts} "
            for row, dur in zip(timestamps, duration)
            for ts in _render_timestamps(row, dur, cfg.time_format)
        ]
        ts_enc = self.llm_tokenizer(
            flat_ts, max_length=cfg.tokens_per_timestamp,
            padding_side="right", truncation_side="right",
        )
        if ts_enc.num_truncated:
            worst = flat_ts[int(np.argmax(ts_enc.lengths))]
            raise ValueError(
                f"{ts_enc.num_truncated} timestamp renderings exceed "
                f"tokens_per_timestamp={cfg.tokens_per_timestamp} "
                f"(e.g. {worst!r} -> {int(ts_enc.lengths.max())} tokens)")
        dur_enc = self.llm_tokenizer(
            [f"{dur} " for dur in duration], max_length=cfg.tokens_per_duration,
            padding_side="right", truncation_side="right",
        )
        if dur_enc.num_truncated:
            raise ValueError(
                f"{dur_enc.num_truncated} duration renderings exceed "
                f"tokens_per_duration={cfg.tokens_per_duration}")
        common = dict(
            qformer_ids=q_enc.input_ids, qformer_mask=q_enc.attention_mask,
            ts_ids=ts_enc.input_ids.reshape(b, t, cfg.tokens_per_timestamp),
            ts_mask=ts_enc.attention_mask.reshape(b, t, cfg.tokens_per_timestamp),
            dur_ids=dur_enc.input_ids, dur_mask=dur_enc.attention_mask,
        )
        if text_output is None:
            prompt_enc = self.llm_tokenizer(
                [p.strip() for p in text_input], max_length=cfg.max_txt_len,
                padding_side="left", truncation_side="left",
            )
            return TextBatch(prompt_ids=prompt_enc.input_ids,
                             prompt_mask=prompt_enc.attention_mask, **common)

        # Train: [prompt with BOS, target without BOS plus EOS, padding];
        # the labels mask the padding and the prompt.  The target keeps
        # max_output_txt_len - 1 tokens: the reference truncates before it
        # strips the BOS.
        tok = self.llm_tokenizer
        total = cfg.max_txt_len + cfg.max_output_txt_len
        concat_ids = np.full((b, total), tok.pad_token_id, np.int32)
        concat_mask = np.zeros((b, total), np.int32)
        labels = np.full((b, total), -100, np.int32)
        prompt_ids = np.full((b, cfg.max_txt_len), tok.pad_token_id, np.int32)
        prompt_mask = np.zeros((b, cfg.max_txt_len), np.int32)
        for i, (inp, out) in enumerate(zip(text_input, text_output)):
            in_ids = tok.encode(inp, add_special_tokens=True)[-cfg.max_txt_len:]
            out_ids = tok.encode(out, add_special_tokens=False) + [tok.eos_token_id]
            out_ids = out_ids[: cfg.max_output_txt_len - 1]
            seq = (in_ids + out_ids)[:total]
            concat_ids[i, : len(seq)] = seq
            concat_mask[i, : len(seq)] = 1
            labels[i, : len(seq)] = seq
            labels[i, : min(len(in_ids), total)] = -100
            prompt_ids[i, : len(in_ids)] = in_ids
            prompt_mask[i, : len(in_ids)] = 1
        return TextBatch(prompt_ids=prompt_ids, prompt_mask=prompt_mask, concat_ids=concat_ids,
                         concat_mask=concat_mask, labels=labels, **common)

    # ------------------------------------------------------------------
    # Device computation
    # ------------------------------------------------------------------

    def _frames_per_pass(self, b: int, t: int, allow_fpp: bool) -> int:
        cfg = self.cfg
        fpp, gsize = cfg.encode_frames_per_pass, cfg.encode_clips_per_pass
        if allow_fpp and fpp and b * t > fpp and (b * t) % fpp == 0:
            return fpp
        if gsize and b > gsize and b % gsize == 0:
            return gsize * t
        return b * t

    def _encode_modality_tokens(self, video_u8, audio_wave, qformer_ids, qformer_mask,
                                n_frms: int, crop_params=None) -> dict:
        """uint8 video + waveform → {modality: (B, T, Q, D_llm)}.
        ``crop_params`` (B, 5) applies the train-time crop and flip
        (``ops/image.py::augment_and_normalize``); None is the eval
        preprocessing.  Encoder kernels stored int8 (``--quant-encoders``,
        ``train.quant_frozen``; ``models/quant_tree.py``) dequantize as
        they are read."""
        cfg = self.cfg
        out = {}
        if "video" in cfg.modalities:
            b, t = video_u8.shape[:2]
            if cfg.video_wire == "yuv420":
                video_u8 = yuv420_to_rgb(video_u8)     # the I420 wire → f32 RGB
            if crop_params is not None:
                frames = augment_and_normalize(video_u8, crop_params, cfg.vit.image_size,
                                               dtype=torch_dtype(cfg.vit.dtype))
            else:
                frames = normalize_frames(video_u8, dtype=torch_dtype(cfg.vit.dtype))
            folded = frames.reshape((b * t,) + frames.shape[2:])
            # the temporal-residual ViT needs whole clips in each pass
            per = self._frames_per_pass(b, t, cfg.vit.keyframe_interval == 1)
            feats = torch.cat([self.vit(folded[i:i + per], n_frms=t)
                               for i in range(0, b * t, per)])
            feats = self.video_ln(feats)
            out["video"] = self._qformer_project("video", feats, b, t, qformer_ids, qformer_mask)
        if "audio" in cfg.modalities:
            fbank = beats_frontend(audio_wave, self.audio_cfg, n_frms)
            b, t = fbank.shape[:2]
            folded = fbank.reshape((b * t,) + fbank.shape[2:])
            per = self._frames_per_pass(b, t, True)
            feats = torch.cat([self.beats(folded[i:i + per]) for i in range(0, b * t, per)])
            feats = self.audio_ln(feats)
            out["audio"] = self._qformer_project("audio", feats, b, t, qformer_ids, qformer_mask)
        return out

    def _qformer_project(self, modality, feats, b, t, qformer_ids, qformer_mask):
        cfg = self.cfg
        q = cfg.qformer.num_query_tokens
        query = getattr(self, f"{modality}_query_tokens").expand(b * t, q, cfg.qformer.hidden_size)
        ids = qformer_ids.repeat_interleave(t, dim=0)
        mask = qformer_mask.repeat_interleave(t, dim=0)
        hidden = getattr(self, f"{modality}_qformer")(query, ids, mask, feats)
        tokens = getattr(self, f"{modality}_proj")(hidden[:, :q])
        return tokens.reshape(b, t, q, cfg.llm.hidden_size)

    def _build_prefix(self, modal_tokens, ts_ids, ts_mask, dur_ids, dur_mask):
        """Interleave per-frame segments + duration → (B, S_prefix, D), mask."""
        b, t, q, d = next(iter(modal_tokens.values())).shape
        dev = self.device
        segs, seg_masks = [], []
        for modality in ("video", "audio"):
            if modality not in modal_tokens:
                continue
            cue = torch.from_numpy(self.cue_ids[modality]).to(dev)
            cue_emb = self.llm.embed(cue[None])                      # (1, Lc, D)
            cue_emb = cue_emb[:, None].expand(b, t, cue.shape[0], d)
            segs += [cue_emb, modal_tokens[modality]]
            seg_masks += [
                torch.ones((b, t, cue.shape[0]), dtype=torch.int32, device=dev),
                torch.ones((b, t, q), dtype=torch.int32, device=dev),
            ]
        if self.cfg.interleave_seconds:
            ts_emb = self.llm.embed(ts_ids.reshape(b, -1)).reshape(b, t, ts_ids.shape[-1], d)
            segs.append(ts_emb)
            seg_masks.append(ts_mask.to(torch.int32))
        frame_block = torch.cat(segs, dim=2).reshape(b, -1, d)
        frame_mask = torch.cat(seg_masks, dim=2).reshape(b, -1)
        prefix = torch.cat([frame_block, self.llm.embed(dur_ids)], dim=1)
        prefix_mask = torch.cat([frame_mask, dur_mask.to(torch.int32)], dim=1)
        return prefix, prefix_mask

    def prefix_mask_host(self, text: TextBatch, n_frms: int) -> np.ndarray:
        """The mask :meth:`prefix_embeds` returns, computed on the host from
        the text masks and the static token counts (cue lengths, query
        tokens), so a caller that needs only the mask does not wait on
        the device."""
        cfg = self.cfg
        b = text.prompt_mask.shape[0]
        parts = []
        for m in ("video", "audio"):
            if m in cfg.modalities:
                parts += [np.ones((b, n_frms, len(self.cue_ids[m])), np.int32),
                          np.ones((b, n_frms, cfg.qformer.num_query_tokens), np.int32)]
        if cfg.interleave_seconds:
            parts.append(np.asarray(text.ts_mask, np.int32))
        frame = np.concatenate(parts, axis=2).reshape(b, -1)
        return np.concatenate([frame, np.asarray(text.dur_mask, np.int32),
                               np.asarray(text.prompt_mask, np.int32)], axis=1)

    @torch.inference_mode()
    def prefix_and_prompt(self, video, audio, qformer_ids, qformer_mask, ts_ids, ts_mask,
                          dur_ids, dur_mask, prompt_ids, prompt_mask, n_frms: int):
        """:meth:`prefix_embeds` over arrays given one by one, each a
        device tensor (used as it is) or a host array (copied to the
        device): the serving encoder pass, whose inputs may already have
        been uploaded."""
        video, audio = (a if isinstance(a, torch.Tensor)
                        else torch.from_numpy(np.asarray(a)).to(self.device)
                        for a in (video, audio))
        return self.prefix_embeds(video, audio, TextBatch(
            qformer_ids, qformer_mask, ts_ids, ts_mask, dur_ids, dur_mask, prompt_ids,
            prompt_mask), n_frms)

    def prefix_embeds(self, video_u8, audio_wave, text: TextBatch, n_frms: int):
        """Encoders + interleave + prompt → (embeds (B, S, D), mask (B, S)).
        The text arrays may be host arrays or tensors already on the
        device."""
        return self._prefix_embeds(video_u8, audio_wave, text, n_frms)[:2]

    def _prefix_embeds(self, video_u8, audio_wave, text: TextBatch, n_frms: int):
        """:meth:`prefix_embeds` and the modal tokens it was built from."""
        dev = self.device

        def dv(a):
            if isinstance(a, torch.Tensor):
                return a.to(dev)
            return torch.from_numpy(np.asarray(a)).to(dev)

        modal = self._encode_modality_tokens(
            video_u8, audio_wave, dv(text.qformer_ids), dv(text.qformer_mask), n_frms)
        prefix, pmask = self._build_prefix(
            modal, dv(text.ts_ids), dv(text.ts_mask), dv(text.dur_ids), dv(text.dur_mask))
        prompt_emb = self.llm.embed(dv(text.prompt_ids))
        embeds = torch.cat([prefix, prompt_emb], dim=1)
        mask = torch.cat([pmask, dv(text.prompt_mask).to(torch.int32)], dim=1)
        return embeds, mask, modal

    # ------------------------------------------------------------------
    # Public entry points
    # ------------------------------------------------------------------

    def _wire_video(self, video) -> np.ndarray:
        """The configured host→device wire: with ``video_wire="yuv420"`` a
        5-D RGB array is packed to I420 here; a 4-D array is already
        packed (the dataset's ``video_wire="yuv420"``)."""
        video = np.asarray(video)
        if self.cfg.video_wire == "yuv420" and video.ndim == 5:
            return rgb_to_yuv420(video)
        return video

    def device_inputs(self, batch) -> tuple:
        """Copy the batch's video (on the configured wire) and audio arrays
        to the device."""
        dev = self.device
        return (torch.from_numpy(self._wire_video(batch.video)).to(dev, non_blocking=True),
                torch.from_numpy(np.asarray(batch.audio)).to(dev, non_blocking=True))

    def _grammar_arrays(self) -> dict:
        """The span grammar's tables (``text/grammar.py``) against the LLM
        tokenizer, on the device, compiled once.  Float windows only for
        the float time formats.  The tables are widened to the padded
        vocabulary: pad ids are never allowed."""
        if getattr(self, "_grammar_cache", None) is None:
            from mraudio_tpu_torch.text.grammar import compile_grammar

            tables = compile_grammar(
                self.llm_tokenizer,
                allow_float=self.cfg.time_format in ("seconds_floats", "relative_floats"))
            allowed, next_state, dist_next = tables.allowed, tables.next_state, tables.dist_next
            pv = self.cfg.llm.padded_vocab_size
            if pv > allowed.shape[1]:
                pad = ((0, 0), (0, pv - allowed.shape[1]))
                allowed = np.pad(allowed, pad)
                next_state = np.pad(next_state, pad)
                dist_next = np.pad(dist_next, pad, constant_values=np.iinfo(np.int32).max // 2)
            self._grammar_cache = {
                name: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for name, a in (("allowed", allowed), ("next_state", next_state),
                                ("forced", tables.forced), ("dist_next", dist_next))}
        return self._grammar_cache

    def _decode(self, embeds, mask, text: TextBatch, stats: dict | None):
        """The configured decoder over the prefix: grammar-constrained,
        lookup-speculative (hints: the batch's timestamp, duration and
        prompt ids) or greedy."""
        cfg = self.cfg
        eos = self.llm_tokenizer.eos_token_id
        if cfg.constrained_decoding:
            g = self._grammar_arrays()
            return grammar_generate(self.llm, embeds, mask, cfg.max_new_tokens, eos,
                                    g["allowed"], g["next_state"], g["forced"], g["dist_next"],
                                    spec_width=cfg.spec_width, stats=stats)
        if cfg.lookup_spec >= 2:
            b = text.prompt_ids.shape[0]
            hint_ids = np.concatenate([text.ts_ids.reshape(b, -1), text.dur_ids,
                                       text.prompt_ids], axis=1)
            hint_mask = np.concatenate([text.ts_mask.reshape(b, -1), text.dur_mask,
                                        text.prompt_mask], axis=1)
            return lookup_generate(self.llm, embeds, mask, cfg.max_new_tokens, eos,
                                   spec_width=cfg.lookup_spec,
                                   hint_ids=torch.from_numpy(hint_ids).to(self.device),
                                   hint_mask=torch.from_numpy(hint_mask).to(self.device),
                                   stats=stats)
        return greedy_generate(self.llm, embeds, mask, cfg.max_new_tokens, eos, stats=stats)

    @torch.inference_mode()
    def generate_submit(self, params=None, batch=None, device_inputs=None,
                        stats: dict | None = None):
        """Run preprocessing, encoders, interleave, prefill and the decode
        loop; returns ``(tokens (B, max_new_tokens), saliency)`` on the
        device, ``saliency`` (B, T) from the same encoder pass with
        ``cfg.saliency_head``, else None.  ``stats``, if given, receives ``encode_s`` and
        ``prefix_len`` plus what the decoder records; the
        encoding runs inside a profiler span named ``encode``.  ``params`` is accepted for signature parity with the
        JAX package and must be None: the weights live in the module."""
        if params is not None:
            raise ValueError("the port's weights live in the module; pass params=None")
        t0 = time.perf_counter()
        with record_function("encode"):
            n_frms = batch.timestamps.shape[1]
            text = self.prepare_text(batch.text_input, np.asarray(batch.timestamps),
                                     batch.duration)
            video_dev, audio_dev = device_inputs or self.device_inputs(batch)
            embeds, mask, modal = self._prefix_embeds(video_dev, audio_dev, text, n_frms)
            saliency = self.saliency_head(modal["video"]) if self.cfg.saliency_head else None
            del modal
            if stats is not None:
                if embeds.is_cuda:
                    torch.cuda.synchronize(embeds.device)
                stats["encode_s"] = time.perf_counter() - t0
                stats["prefix_len"] = embeds.shape[1]
        return self._decode(embeds, mask, text, stats), saliency

    def generate_finalize(self, pending, return_saliency: bool = False):
        """Decode a :meth:`generate_submit` result to strings; with
        ``return_saliency``, ``(texts, (B, T) saliency or None)``."""
        tokens, saliency = pending
        tokens = tokens.cpu().numpy().copy()
        tokens[tokens == 0] = self.llm_tokenizer.eos_token_id  # id 0 → EOS before decode
        texts = self.llm_tokenizer.batch_decode(tokens, skip_special_tokens=True)
        texts = [t.strip() for t in texts]
        if return_saliency:
            return texts, (saliency.float().cpu().numpy() if saliency is not None else None)
        return texts

    def generate(self, params=None, batch=None, device_inputs=None,
                 return_saliency: bool = False, stats: dict | None = None):
        """Batched span generation → decoded strings."""
        return self.generate_finalize(
            self.generate_submit(params, batch, device_inputs, stats=stats),
            return_saliency=return_saliency,
        )

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------

    def _loss_fn(self, video_u8, audio_wave, qformer_ids, qformer_mask, ts_ids, ts_mask,
                 dur_ids, dur_mask, concat_ids, concat_mask, labels, saliency_labels=None,
                 crop_params=None, dropout_key=None, *, n_frms: int):
        """The training forward → scalar loss: the encoders (with the crop
        and flip of ``crop_params``), then :meth:`_loss_from_tokens`.
        ``dropout_key`` turns LoRA dropout on."""
        modal = self._encode_modality_tokens(video_u8, audio_wave, qformer_ids, qformer_mask,
                                             n_frms, crop_params=crop_params)
        return self._loss_from_tokens(modal, ts_ids, ts_mask, dur_ids, dur_mask, concat_ids,
                                      concat_mask, labels, saliency_labels,
                                      dropout_key=dropout_key)

    def _loss_from_tokens(self, modal, ts_ids, ts_mask, dur_ids, dur_mask, concat_ids,
                          concat_mask, labels, saliency_labels=None, dropout_key=None):
        """CE (+ saliency BCE) from precomputed modal tokens; reads only the
        ``llm`` (and ``saliency_head``) parameters."""
        prefix, pmask = self._build_prefix(modal, ts_ids, ts_mask, dur_ids, dur_mask)
        embeds = torch.cat([prefix, self.llm.embed(concat_ids)], dim=1)
        mask = torch.cat([pmask, concat_mask.to(torch.int32)], dim=1)
        # prefix positions never carry a loss
        full_labels = torch.cat([torch.full(pmask.shape, -100, dtype=torch.int64,
                                            device=mask.device), labels.long()], dim=1)
        s = embeds.shape[1]
        causal = torch.ones((s, s), dtype=torch.bool, device=mask.device).tril()[None, None]
        attend = causal & (mask[:, None, None, :] > 0)
        hidden, _ = self.llm(embeds, attend, positions_from_mask(mask), kv_valid=mask,
                             causal=True, return_hidden=True, dropout_key=dropout_key)
        loss = self._chunked_ce(hidden[:, :-1], full_labels[:, 1:])

        # sigmoid BCE of the per-frame scores against in-window labels;
        # -1 labels are ignored
        if self.cfg.saliency_head and saliency_labels is not None:
            scores = self.saliency_head(modal["video"]).float()
            sl = saliency_labels.float()
            valid = sl >= 0
            target = torch.where(valid, sl, 0.0)
            bce = (torch.clamp(scores, min=0) - scores * target
                   + torch.log1p(torch.exp(-scores.abs())))
            loss = loss + (bce * valid).sum() / self._global_count(valid.sum()).clamp(min=1)
        return loss

    def _global_count(self, count: torch.Tensor) -> torch.Tensor:
        """``count`` summed over the data ranks of a mesh: each rank's loss
        is its own sum over the global batch's count, so the ranks' losses
        (and gradients) add up to the global batch's mean."""
        mesh = getattr(self, "mesh", None)
        return count if mesh is None else comm.all_reduce_sum(count, mesh.data_group)

    def _chunked_ce(self, hidden, labels, chunk: int = 512):
        """Mean token CE over the targets that are not -100 (HF semantics),
        ``chunk`` positions at a time: the lm_head and log-softmax of a
        chunk are recomputed in the backward (``torch.utils.checkpoint``)
        when a gradient is taken, so no (B, S, V) f32 tensor is kept."""
        b, s, _ = hidden.shape
        pad = (-s) % chunk
        if pad:
            hidden = F.pad(hidden, (0, 0, 0, pad))
            labels = F.pad(labels, (0, pad), value=-100)

        def step(h_blk, l_blk):
            logits = self.llm.logits(h_blk)
            valid = l_blk != -100
            safe = torch.where(valid, l_blk, 0)
            tok = torch.log_softmax(logits, dim=-1).gather(-1, safe[..., None])[..., 0]
            return (tok * valid).sum(), valid.sum()

        remat = torch.is_grad_enabled() and hidden.requires_grad
        ll_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
        count = torch.zeros((), dtype=torch.int64, device=hidden.device)
        for c in range(0, s + pad, chunk):
            args = (hidden[:, c:c + chunk], labels[:, c:c + chunk])
            if remat:
                ll, n = checkpoint(step, *args, use_reentrant=False, preserve_rng_state=False)
            else:
                ll, n = step(*args)
            ll_sum, count = ll_sum + ll, count + n
        return -ll_sum / self._global_count(count).clamp(min=1)

    def loss_arrays(self, batch) -> tuple:
        """Host-side text prep → the host arrays :meth:`_loss_fn` takes, in
        its order (with ``saliency_head``, the saliency labels last)."""
        text = self.prepare_text(batch.text_input, np.asarray(batch.timestamps), batch.duration,
                                 text_output=batch.text_output)
        arrays = (
            self._wire_video(batch.video), np.asarray(batch.audio),
            text.qformer_ids, text.qformer_mask, text.ts_ids, text.ts_mask,
            text.dur_ids, text.dur_mask, text.concat_ids, text.concat_mask, text.labels,
        )
        if self.cfg.saliency_head:
            arrays = arrays + (self._saliency_labels(batch),)
        return arrays

    def device_arrays(self, arrays: tuple) -> tuple:
        """:meth:`loss_arrays`' host arrays as tensors on the model's device."""
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device) for a in arrays)

    @staticmethod
    def _saliency_labels(batch) -> np.ndarray:
        """(B, T) {0, 1} per-frame in-window labels from the training
        targets (``text_output`` is ``str(relevant_windows)``); -1 where
        the windows do not parse."""
        stamps = np.asarray(batch.timestamps)
        labels = np.full(stamps.shape, -1.0, np.float32)
        for i, out in enumerate(batch.text_output):
            try:
                windows = ast.literal_eval(out)
            except (ValueError, SyntaxError):
                continue
            if not isinstance(windows, (list, tuple)):
                continue
            row = np.zeros(stamps.shape[1], np.float32)
            for w in windows:
                if isinstance(w, (list, tuple)) and len(w) == 2:
                    row += (stamps[i] >= w[0]) & (stamps[i] <= w[1])
            labels[i] = np.minimum(row, 1.0)
        return labels

    def loss(self, params=None, batch=None, crop_params=None, dropout_key=None) -> torch.Tensor:
        """Training forward → scalar loss.  ``crop_params`` (B, 5) applies
        the train-time crop and flip (``ops/image.py::sample_crop_params``)."""
        if params is not None:
            raise ValueError("the port's weights live in the module; pass params=None")
        arrays = self.device_arrays(self.loss_arrays(batch))
        crop = None if crop_params is None else torch.as_tensor(crop_params).to(self.device)
        return self._loss_fn(*arrays, crop_params=crop, dropout_key=dropout_key,
                             n_frms=batch.timestamps.shape[1])
