"""Typed configuration for the PyTorch port.

The same dataclasses, field names and defaults as the JAX package's
configuration, restricted to what the X-InstructBLIP generate path and
the evaluate driver read.  PyYAML is imported only inside
:meth:`from_yaml`/:meth:`to_yaml`, so importing the configuration needs
nothing beyond the standard library.  :meth:`from_yaml` reads a config
written as JSON (which is YAML) with ``json``, so such a config needs no
PyYAML and keeps JSON's number syntax (PyYAML reads ``1e-06`` as a
string).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


class _ConfigBase:
    @classmethod
    def from_dict(cls, data: dict):
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in data:
                continue
            value = data[f.name]
            sub = _DATACLASS_FIELD_TYPES.get((cls.__name__, f.name))
            if sub is not None and isinstance(value, dict):
                value = sub.from_dict(value)
            kwargs[f.name] = value
        return cls(**kwargs)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_yaml(cls, path: str):
        import json

        with open(path) as f:
            text = f.read()
        try:
            data = json.loads(text)
        except json.JSONDecodeError:
            import yaml

            data = yaml.safe_load(text)
        return cls.from_dict(data or {})

    def to_yaml(self, path: str) -> None:
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)

    def replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)


@dataclass(frozen=True)
class ViTConfig(_ConfigBase):
    """EVA-ViT-g/14 frame encoder: 224² → 257 tokens × 1408 features,
    39 pre-norm blocks."""

    image_size: int = 224
    patch_size: int = 14
    width: int = 1408
    depth: int = 39
    num_heads: int = 16
    mlp_dim: int = 6144
    use_class_token: bool = True
    layer_norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    mlp_act: str = "gelu"          # "gelu" (exact erf), "quick_gelu", "gelu_tanh"
    # Recompute each block in the backward (training with gradients
    # through the encoder only: split_encode_step=False).
    grad_checkpoint: bool = False
    # Temporal-residual encoding: every keyframe_interval-th frame runs
    # the full transformer, the others only their residual_tokens
    # most-changed patches (models/eva_vit.py; 1 = every frame in full).
    keyframe_interval: int = 1
    residual_tokens: int = 64

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + int(self.use_class_token)


@dataclass(frozen=True)
class BeatsConfig(_ConfigBase):
    """BEATs audio encoder: 128-mel fbank patches → 768-dim tokens, 12
    post-LN layers with gated relative position bias."""

    num_mel_bins: int = 128
    patch_size: int = 16
    patch_stride: int = 16
    conv_dim: int = 512
    width: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    conv_pos_kernel: int = 128
    conv_pos_groups: int = 16
    rel_pos_buckets: int = 320
    rel_pos_max_distance: int = 800
    layer_norm_eps: float = 1e-5
    dtype: str = "bfloat16"


@dataclass(frozen=True)
class QFormerConfig(_ConfigBase):
    """Per-modality Q-Former: BERT-base with cross-attention every
    ``cross_attention_freq`` layers and 32 learned query tokens."""

    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    cross_attention_freq: int = 2
    num_query_tokens: int = 32
    vocab_size: int = 30523
    max_position_embeddings: int = 512
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    dtype: str = "bfloat16"


@dataclass(frozen=True)
class LlamaConfig(_ConfigBase):
    """Vicuna-7B v1.1 decoder; vocab 32000 + [PAD]."""

    vocab_size: int = 32001
    # Round the embedding/lm_head vocab up to a multiple of this; the
    # pad logit columns are masked to finfo.min.
    vocab_pad_multiple: int = 1
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    intermediate_size: int = 11008
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    max_seq_len: int = 4096
    dtype: str = "bfloat16"
    attention_bias: bool = False
    # "none" | "int8" (per-output-channel weight-only) | "int4" (group-wise,
    # int4_group_size input rows per f32 scale, two values per byte)
    quantization: str = "none"
    int4_group_size: int = 128
    # W8A8 on the int8 weights: per-row int8 activations, an exact int32
    # product (an approximation of the weight-only path; precedes the GEMV)
    int8_dot: bool = False
    # KV-cache storage: "none" | "int8" (per-(row, position, head) absmax
    # with f32 scales) | "int4" (the same, 15 levels, two values per byte)
    kv_quant: str = "none"
    # Post-prefill KV compaction, SnapKV (0 = off): each layer keeps its
    # `kv_keep` prefix columns with the most attention mass from the last
    # `kv_keep_obs` prefix queries; the first `kv_keep_sink` columns and
    # the observation window are always kept.  An approximation.
    kv_keep: int = 0
    kv_keep_obs: int = 32
    kv_keep_sink: int = 4
    # Training: recompute each decoder block in the backward
    # (torch.utils.checkpoint), keeping one block input per layer.
    grad_checkpoint: bool = False
    # Decode-shaped projections (<= 32 rows) go through the
    # order-preserving GEMV kernel when "pallas" (the name is kept from
    # the JAX package; here it selects ops/gemv.py's CUDA kernel).
    decode_gemv: str = "xla"
    # Multi-token attention: "chunked" runs the plain online-softmax
    # chunked_attention over the cache (ops/attention.py); "pallas"
    # selects the flash-attention kernel for queries that start at
    # column 0 (later prefill segments take chunked_attention); "dense"
    # materializes the logits.
    attention_impl: str = "chunked"
    attention_unroll_prefill: bool = False
    # Accepted and read nowhere: in the JAX package it unrolls XLA's loop
    # over the training path's attention tiles, which changes no
    # arithmetic; the port's tile loop is a Python loop already.
    attention_unroll_train: bool = False
    # Tile the MLP's token axis in chunks of this many (0 = off); each tile
    # is recomputed in the backward.
    mlp_seq_chunk: int = 0
    # Segmented prefill: segments of this many prefix tokens (0 = one-shot).
    prefill_chunk: int = 2048
    # The JAX package's nn.scan parameter layout: the decoder's leaves are
    # stored stacked under llm/layers at every boundary (converters, param
    # store, checkpoints); the modules and the cache stay per layer.
    scan_layers: bool = False
    # Megatron sequence parallelism on a model axis > 1: the residual
    # stream between the tensor-parallel matmuls is split along S over the
    # model ranks (the last shard zero-padded when S does not tile); a
    # no-op without a model axis and for fewer than 2 tokens per rank.
    seq_shard: bool = False
    # The port's own fields (the JAX package has neither mechanism; each
    # default keeps today's dense decoder).  Attention: "gqa" (grouped-
    # query or full multi-head, K and V per KV head in the cache) or "mla"
    # (DeepSeek-V3 latent attention, models/mla.py: per token a
    # kv_lora_rank latent and one qk_rope_head_dim roped key in the cache,
    # shared by every head; queries qk_nope_head_dim + qk_rope_head_dim
    # wide, values v_head_dim).  rope_interleave rotates (2i, 2i + 1)
    # pairs instead of the two halves (read by "mla" only).
    attention_kind: str = "gqa"
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    rope_interleave: bool = False
    # Sparse experts (models/moe.py; 0 routed experts = every layer
    # dense): from layer first_k_dense_replace on, each token goes to
    # num_experts_per_tok of n_routed_experts SwiGLU experts of width
    # moe_intermediate_size, chosen by DeepSeek-V3's sigmoid router, its
    # weights renormalised (norm_topk_prob) and scaled by
    # routed_scaling_factor, plus n_shared_experts experts every token
    # passes through.
    n_routed_experts: int = 0
    num_experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_intermediate_size: int = 0
    first_k_dense_replace: int = 0
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def padded_vocab_size(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab_size // m) * m if m > 1 else self.vocab_size

    def moe_layer(self, layer: int) -> bool:
        """Whether decoder layer ``layer`` routes to sparse experts."""
        return self.n_routed_experts > 0 and layer >= self.first_k_dense_replace


@dataclass(frozen=True)
class LoraConfig(_ConfigBase):
    """LoRA adapters on the LLM's linear projections (r=8, alpha=8)."""

    enabled: bool = True
    rank: int = 8
    alpha: int = 8
    dropout: float = 0.05
    target_modules: tuple = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


@dataclass(frozen=True)
class XInstructBLIPConfig(_ConfigBase):
    """Assembly config: modalities, interleave layout and token budgets."""

    modalities: tuple = ("audio", "video")
    interleave_seconds: bool = True
    enumerate_inputs: bool = False
    time_format: str = "seconds_integers"
    max_txt_len: int = 128
    max_output_txt_len: int = 64
    max_new_tokens: int = 64
    tokens_per_timestamp: int = 5
    tokens_per_duration: int = 5
    prefix: str = ""
    postfix: str = ""
    # Grammar-constrained decoding with forced-token speculation over
    # spec_width draft positions (infer/generate.py::grammar_generate).
    constrained_decoding: bool = False
    spec_width: int = 4
    # >= 2: lookup self-speculation over that many positions, tokens
    # identical to greedy (infer/generate.py::lookup_generate).
    lookup_spec: int = 0
    # Per-frame saliency head over the video query tokens (QVH highlight
    # scores); it trains with the LoRA adapters.
    saliency_head: bool = False
    # "rgb" ships uint8 (B, T, H, W, 3); "yuv420" the I420 planes packed
    # (B, T, H*3/2, W), RGB rebuilt on the device (ops/image.py).
    video_wire: str = "rgb"
    # Clips per encoder pass (bounds the encoders' f32 attention-logits
    # temporaries to one clip's frames).  0 = the whole batch in one pass.
    encode_clips_per_pass: int = 1
    encode_frames_per_pass: int = 0
    vit: ViTConfig = field(default_factory=ViTConfig)
    beats: BeatsConfig = field(default_factory=BeatsConfig)
    qformer: QFormerConfig = field(default_factory=QFormerConfig)
    llm: LlamaConfig = field(default_factory=LlamaConfig)
    lora: LoraConfig = field(default_factory=LoraConfig)


DATASET_N_FRMS = {"QVH": 60, "Charades_STA": 20}
DATASET_MAX_AUDIO_SECONDS = {"QVH": 152.0, "Charades_STA": 45.0}


@dataclass(frozen=True)
class AudioFrontendConfig(_ConfigBase):
    """Kaldi-style 128-bin log-mel fbank over 16 kHz mono, split into
    per-frame chunks of ``mel_frames_per_chunk`` mel frames."""

    sampling_rate: int = 16000
    num_mel_bins: int = 128
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    mel_frames_per_chunk: int = 512
    preemphasis: float = 0.97
    dither: float = 0.0
    max_audio_seconds: float = 0.0

    @property
    def win_length(self) -> int:
        return int(self.sampling_rate * self.frame_length_ms / 1000)

    @property
    def hop_length(self) -> int:
        return int(self.sampling_rate * self.frame_shift_ms / 1000)


@dataclass(frozen=True)
class DataConfig(_ConfigBase):
    """Evaluation data: annotation JSONL, frame sampling and the media
    sources (``data/``)."""

    dataset: str = "QVH"
    video_folder: str = ""
    annotation_file: str = ""
    train_annotation_file: str = ""
    val_annotation_file: str = ""
    n_frms: int = 60
    image_size: int = 224
    sampling: str = "uniform"      # "uniform" (eval) or "random" (train)
    min_scale: float = 0.9
    max_scale: float = 1.0
    # "native" (libav through native/mraudio_native.cc), "synthetic"
    # (procedural, keyed on the path), "npy" (pre-extracted arrays)
    video_source: str = "native"
    video_wire: str = "rgb"        # "rgb" or "yuv420" (get_batch_i420)
    audio: AudioFrontendConfig = field(default_factory=AudioFrontendConfig)
    num_chunks: int = 1
    chunk_idx: int = 0
    prefetch_depth: int = 2
    prompt_style: str = "live"     # "live" or "fewshot" (text/prompts.py)

    @classmethod
    def for_dataset(cls, dataset: str, **kwargs) -> "DataConfig":
        if dataset not in DATASET_N_FRMS:
            raise ValueError(
                f"unknown dataset {dataset!r}; expected one of {sorted(DATASET_N_FRMS)}"
            )
        kwargs.setdefault(
            "audio",
            AudioFrontendConfig(max_audio_seconds=DATASET_MAX_AUDIO_SECONDS[dataset]),
        )
        return cls(dataset=dataset, n_frms=DATASET_N_FRMS[dataset], **kwargs)


@dataclass(frozen=True)
class MeshConfig(_ConfigBase):
    """Device mesh axes.  Data parallelism over ``data``; Megatron tensor
    parallelism of the LLM over ``model`` (heads, MLP width and vocab
    sharded), with the frozen encoders ZeRO-3-sharded over ``data``.  The
    reference's only strategy is DP via DDP.  One process per device: a
    mesh of ``num_devices`` > 1 runs under a distributed launch of exactly
    that many processes (``parallel/mesh.py``)."""

    data: int = 1
    model: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.model


@dataclass(frozen=True)
class TrainConfig(_ConfigBase):
    """LoRA fine-tuning (``train/trainer.py``); ``seed`` also seeds the
    random init of ``run_inference``.  ``quant_frozen="int8"`` stores the
    frozen kernels int8 (``models/quant_tree.py``); ``encoder_window`` W
    keeps the frozen encoders on the host between windows of W batches,
    and ``upload_overlap`` stages the next window's upload during the
    current window's loss steps (``utils/packing.py``)."""

    lr: float = 3e-4
    weight_decay: float = 0.05
    betas: tuple = (0.9, 0.999)
    warmup_steps: int = 1000
    warmup_start_lr: float = 1e-8
    min_lr: float = 0.0
    accum_grad_iters: int = 2
    max_epoch: int = 50
    val_freq: int = 1
    save_freq: int = 1
    batch_size: int = 1
    num_workers: int = 2
    augment: bool = True
    seed: int = 42
    output_dir: str = "output"
    resume_ckpt_path: str = ""
    nan_guard: bool = True
    max_nan_skips: int = 10
    preempt_save: bool = True
    split_encode_step: bool = True
    quant_frozen: str = "none"
    encoder_window: int = 0
    upload_overlap: bool = False


@dataclass(frozen=True)
class RunConfig(_ConfigBase):
    """Top-level config: one object per entry point."""

    model_name: str = "X-InstructBLIP"
    model: XInstructBLIPConfig = field(default_factory=XInstructBLIPConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    # store the frozen encoders' large kernels int8 (models/quant_tree.py)
    quant_encoders: bool = False
    # paths to the reference's checkpoints, converted at load (empty =
    # random init)
    llm_weights: str = ""
    vit_weights: str = ""
    beats_weights: str = ""
    video_qformer_weights: str = ""
    audio_qformer_weights: str = ""
    blip2_stage1_weights: str = ""
    tokenizer_path: str = ""


_DATACLASS_FIELD_TYPES = {
    ("XInstructBLIPConfig", "vit"): ViTConfig,
    ("XInstructBLIPConfig", "beats"): BeatsConfig,
    ("XInstructBLIPConfig", "qformer"): QFormerConfig,
    ("XInstructBLIPConfig", "llm"): LlamaConfig,
    ("XInstructBLIPConfig", "lora"): LoraConfig,
    ("DataConfig", "audio"): AudioFrontendConfig,
    ("RunConfig", "model"): XInstructBLIPConfig,
    ("RunConfig", "data"): DataConfig,
    ("RunConfig", "train"): TrainConfig,
    ("RunConfig", "mesh"): MeshConfig,
}


def tiny_model_config(
    modalities: tuple = ("audio", "video"), quantization: str = "none"
) -> XInstructBLIPConfig:
    """The full architecture at toy width, for tests."""
    return XInstructBLIPConfig(
        modalities=modalities,
        vit=ViTConfig(image_size=28, patch_size=14, width=32, depth=2, num_heads=2, mlp_dim=64),
        beats=BeatsConfig(
            num_mel_bins=16, patch_size=4, patch_stride=4, conv_dim=16, width=32,
            depth=2, num_heads=2, mlp_dim=64, conv_pos_kernel=8, conv_pos_groups=2,
            rel_pos_buckets=16, rel_pos_max_distance=32,
        ),
        qformer=QFormerConfig(
            hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
            num_query_tokens=4, vocab_size=260, max_position_embeddings=64,
        ),
        llm=LlamaConfig(
            vocab_size=260, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=4, intermediate_size=128, max_seq_len=2048,
            quantization=quantization,
        ),
        lora=LoraConfig(rank=2, alpha=2),
        max_txt_len=48,
        max_output_txt_len=24,
        max_new_tokens=8,
        tokens_per_timestamp=6,
        tokens_per_duration=6,
    )


def full_model_config() -> XInstructBLIPConfig:
    """The production-size stack: int8 weight-only 7B decoder, int8 KV
    cache, vocab padded to a multiple of 8 (32008)."""
    return XInstructBLIPConfig(
        llm=LlamaConfig(quantization="int8", kv_quant="int8",
                        vocab_pad_multiple=8)
    )


def apply_fast_preset(cfg: RunConfig) -> RunConfig:
    """The evaluate CLI's ``--fast`` preset: the temporal-residual ViT
    (``keyframe_interval=4``, ``residual_tokens=64``, an approximation),
    the yuv420 wire for model and data, and grammar-constrained decoding
    with ``spec_width=4`` (every output parses)."""
    model = cfg.model.replace(
        vit=cfg.model.vit.replace(keyframe_interval=4, residual_tokens=64),
        constrained_decoding=True,
        spec_width=4,
        video_wire="yuv420",
    )
    data = cfg.data.replace(video_wire="yuv420")
    return cfg.replace(model=model, data=data)


def tiny_data_config(n_frms: int = 4) -> DataConfig:
    return DataConfig(
        dataset="QVH",
        n_frms=n_frms,
        image_size=28,
        video_source="synthetic",
        audio=AudioFrontendConfig(num_mel_bins=16, mel_frames_per_chunk=32),
    )


def slice_model_config(base: XInstructBLIPConfig | None = None) -> XInstructBLIPConfig:
    """``base`` (default :func:`full_model_config`) with both kernels
    switched on and a one-shot prefill: the configuration the port's
    main path runs."""
    cfg = base if base is not None else full_model_config()
    return cfg.replace(llm=cfg.llm.replace(
        attention_impl="pallas", decode_gemv="pallas", prefill_chunk=0))
