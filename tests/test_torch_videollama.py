"""The port's VideoLLaMA backbone (``models/videollama.py``) against the
JAX package's, from the same parameters (the port's seeded weights with a
non-zero LoRA B, carried into JAX's tree), at the tiny size in f32.

Two flavours: the tiny preset (a CLIP-like tower with a class token, a
Vicuna-like decoder) and the 2.1-AV flavour at tiny width (a SigLIP-like
tower without one, gelu_tanh MLPs, 0.5 / 0.5 normalization; a Qwen2-like
decoder with grouped-query attention, 4 query heads over 2 KV heads, and
q/k/v biases).  Checked: the connector's, the projector's and the
prefix's outputs (each computes in bf16 in both packages: within 2 bf16
ulps + 2^-6 of the row's rms, the prefix exactly equal in practice);
generate's token ids and strings identical over left-padded prompts;
``lookup_spec=4`` giving greedy's tokens; the loss within rel 1e-5 and
each LoRA leaf's gradient within 1e-4 of that leaf's largest |g|
(``jax.value_and_grad``), through the train-time crop; the connector's
and projector's gradients, bf16 products in both packages, within 2^-6
of the leaf's largest |g|; ``loss_arrays`` equal; the connector's token count; the
``videollama21_av_config`` dimensions and ``videollama_flops`` equal to
JAX's."""

import dataclasses
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mraudio_tpu.config import AudioFrontendConfig as JAudioCfg
from mraudio_tpu.models import videollama as jvl
from mraudio_tpu.train.optim import merge_params as j_merge
from mraudio_tpu.train.optim import split_trainable as j_split
from mraudio_tpu.utils.flops import videollama_flops as j_videollama_flops
from mraudio_tpu_torch.config import AudioFrontendConfig, full_model_config
from mraudio_tpu_torch.models import videollama as tvl
from mraudio_tpu_torch.models.convert_jax import flax_params, init_random_, torch_name
from mraudio_tpu_torch.utils.flops import videollama_flops
from test_torch_train_loss import jax_tree, train_batch

torch.set_num_threads(1)

PATTERN = tvl.VideoLLaMA.TRAINABLE_PATTERN
AUDIO = dict(num_mel_bins=16, mel_frames_per_chunk=32)
N_FRMS = 4


def _flavour(mod, name):
    """The tiny config of ``mod`` (either package's videollama module) in
    f32 with LoRA dropout off, in the flavour ``name``."""
    cfg = mod.tiny_videollama_config()
    cfg = cfg.replace(llm=cfg.llm.replace(dtype="float32"), vit=cfg.vit.replace(dtype="float32"),
                      beats=cfg.beats.replace(dtype="float32"),
                      lora=cfg.lora.replace(enabled=True, rank=2, alpha=2, dropout=0.0))
    if name == "qwen2":
        cfg = cfg.replace(vit=cfg.vit.replace(use_class_token=False, mlp_act="gelu_tanh"),
                          llm=cfg.llm.replace(attention_bias=True, rope_theta=1e6,
                                              num_kv_heads=2),
                          image_mean=(0.5, 0.5, 0.5), image_std=(0.5, 0.5, 0.5))
    return cfg


def port_videollama(cfg, seed=3):
    """The port's model on the CPU with seeded weights, non-zero biases
    and a non-zero LoRA B."""
    model = tvl.VideoLLaMA(cfg, audio_cfg=AudioFrontendConfig(**AUDIO), device="cpu")
    init_random_(model, seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_b") or (name.endswith("bias") and "llm" in name):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    return model


@pytest.fixture(scope="module", params=["clip", "qwen2"])
def pair(request):
    """(JAX model, JAX tree, port model) of one flavour."""
    tm = port_videollama(_flavour(tvl, request.param))
    jm = jvl.VideoLLaMA(_flavour(jvl, request.param), audio_cfg=JAudioCfg(**AUDIO))
    return jm, jax_tree(tm), tm


def _batch():
    return train_batch(b=2, t=N_FRMS)


def test_connector_projector_and_prefix_match_jax(pair):
    jm, tree, tm = pair
    rng = np.random.default_rng(0)
    cfg = tm.cfg
    tokens = rng.standard_normal((2, N_FRMS, cfg.vit.num_patches, cfg.vit.width), np.float32)
    chunks = rng.standard_normal((2, N_FRMS, 5, cfg.beats.width), np.float32)
    pairs = [
        (jm.connector.apply({"params": tree["connector"]}, jnp.asarray(tokens)),
         tm.connector(torch.from_numpy(tokens))),
        (jm.audio_proj.apply({"params": tree["audio_proj"]}, jnp.asarray(chunks)),
         tm.audio_proj(torch.from_numpy(chunks))),
    ]
    b = _batch()
    j_prefix, j_mask = jm._prefix(tree, jnp.asarray(b.video), jnp.asarray(b.audio), N_FRMS)
    t_prefix, t_mask = tm._prefix(torch.from_numpy(b.video), torch.from_numpy(b.audio), N_FRMS)
    pairs.append((j_prefix, t_prefix))
    assert np.array_equal(np.asarray(j_mask), t_mask.numpy())
    for j_out, t_out in pairs:
        assert t_out.dtype == torch.bfloat16 and j_out.dtype == jnp.bfloat16
        want = np.asarray(j_out).astype(np.float32)
        got = t_out.float().numpy()
        assert got.shape == want.shape
        # 2 bf16 ulps of |want| + 2^-6 of the rms of want's row: both packages
        # round the first layer's output to bf16 before the second, so an
        # output that cancels moves by a rounding of its terms
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want) + 1e-30)) - 7)
        rms = np.sqrt(np.square(want).mean(-1, keepdims=True))
        assert np.all(np.abs(got - want) <= 2 * ulp + 2.0 ** -6 * rms)


def test_generate_matches_jax(pair):
    """Token ids and strings identical over left-padded prompts of two
    lengths, and lookup decoding (``lookup_spec=4``) gives greedy's
    tokens in both packages."""
    jm, tree, tm = pair
    b = _batch()
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    j_tokens = np.asarray(jm.generate_submit(params, b))
    stats = {}
    t_tokens = tm.generate_submit(batch=b, stats=stats)
    assert np.array_equal(t_tokens.numpy(), j_tokens)
    assert tm.generate_finalize(t_tokens) == jm.generate_finalize(j_tokens)
    lengths = [len(tm.llm_tokenizer.encode(t, add_special_tokens=True)) for t in b.text_input]
    assert lengths[0] != lengths[1]     # the shorter prompt is left-padded
    assert stats["prefix_len"] == (N_FRMS // tm.cfg.temporal_stride * tm.cfg.vit.num_patches
                                   // tm.cfg.spatial_pool ** 2 + N_FRMS + tm.cfg.max_txt_len)
    held = tm.cfg
    tm.cfg = held.replace(lookup_spec=4)
    try:
        assert np.array_equal(tm.generate_submit(batch=b).numpy(), j_tokens)
    finally:
        tm.cfg = held


def test_loss_and_gradients_match_jax(pair):
    jm, tree, tm = pair
    b = _batch()
    crop = np.array([[2, 3, 20, 24, 1], [0, 0, 28, 28, 0]], np.int32)
    arrays = tm.loss_arrays(b)
    tr, fr = j_split(tree, PATTERN)

    def loss_fn(t):
        return jm._loss_fn(j_merge(t, fr), *[jnp.asarray(a) for a in arrays],
                           crop_params=jnp.asarray(crop), n_frms=N_FRMS)

    j_loss, j_grads = jax.value_and_grad(loss_fn)(tr)
    j_grads = {"/".join(k): np.asarray(v) for k, v in j_grads.items()}

    params = dict(tm.named_parameters())
    leaves = {k: params[torch_name(tuple(k.split("/")))]
              for k in flax_params(tm) if re.search(PATTERN, k)}
    assert sorted(leaves) == sorted(j_grads)
    assert any(k.startswith("connector/") for k in leaves)
    assert any(k.startswith("audio_proj/") for k in leaves)
    try:
        for p in leaves.values():
            p.requires_grad_(True)
        loss = tm.loss(batch=b, crop_params=crop)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        loss = loss.detach()
    finally:
        for p in leaves.values():
            p.requires_grad_(False)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    for k, g in zip(leaves, grads):
        want = j_grads[k]
        assert np.abs(want).max() > 0, k
        # the connector and the projector run in bf16 in both packages, so
        # their gradients are bf16 products: held at 2^-6 of the leaf's
        # largest |g| (4 bf16 ulps at the top of its range); the LoRA leaves,
        # computed in f32, at 1e-4
        rel = 2.0 ** -6 if k.startswith(("connector/", "audio_proj/")) else 1e-4
        assert np.abs(g.numpy() - want).max() <= rel * np.abs(want).max(), k


def test_loss_arrays_equal_jax(pair):
    jm, _, tm = pair
    b = _batch()
    for got, want in zip(tm.loss_arrays(b), jm.loss_arrays(b), strict=True):
        assert np.array_equal(got, want) and got.dtype == want.dtype


def test_connector_token_count():
    cfg = tvl.tiny_videollama_config()
    model = tvl.VideoLLaMA(cfg, audio_cfg=AudioFrontendConfig(**AUDIO), device="cpu")
    init_random_(model)
    b, t, p = 2, 4, cfg.vit.num_patches
    tokens = model.connector(torch.zeros((b, t, p, cfg.vit.width)))
    expected = (t // cfg.temporal_stride) * (p // cfg.spatial_pool ** 2)
    assert tokens.shape == (b, expected, cfg.llm.hidden_size)


def test_videollama21_av_config_equals_jax():
    for n_frms in (60, 20, 7):
        ours = tvl.videollama21_av_config(n_frms)
        assert dataclasses.asdict(ours) == dataclasses.asdict(jvl.videollama21_av_config(n_frms))
    cfg = tvl.videollama21_av_config(60)
    assert (cfg.vit.image_size, cfg.vit.num_patches, cfg.vit.use_class_token) == (384, 729, False)
    assert (cfg.llm.num_heads, cfg.llm.num_kv_heads, cfg.llm.quantization) == (28, 4, "none")
    assert (cfg.spatial_pool, cfg.temporal_stride) == (1, 4)


@pytest.mark.parametrize("which", ["full", "videollama21_av"])
def test_videollama_flops_equal_jax(which):
    from mraudio_tpu.config import full_model_config as j_full_model_config

    if which == "full":
        ours = tvl.videollama_config_from(full_model_config(), 60)
        theirs = jvl.videollama_config_from(j_full_model_config(), 60)
        prefill = 960 + 60 + 128
    else:
        ours, theirs = tvl.videollama21_av_config(60), jvl.videollama21_av_config(60)
        prefill = 15 * 729 + 60 + 128
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    got = videollama_flops(ours, AudioFrontendConfig(), 60, 4, prefill, 64)
    want = j_videollama_flops(theirs, JAudioCfg(), 60, 4, prefill, 64)
    assert got == want and got["total"] > 0
