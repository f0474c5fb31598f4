"""Port parity for the whole slice: ``XInstructBLIP.generate`` on the tiny
slice config (int8 weights, int8 KV, both kernel routes on, one-shot
prefill) with 3 synthetic clips of 4 frames, against the JAX package.

f32 everywhere the config allows: identical strings and parsed windows.
bf16 (params cast for inference on both sides): last-position prefill
logits within a stated tolerance."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mraudio_tpu.config import AudioFrontendConfig as JAudioCfg
from mraudio_tpu.config import tiny_model_config as j_tiny
from mraudio_tpu.infer.generate import prefill_cache as j_prefill
from mraudio_tpu.models.casting import cast_params_for_inference as j_cast
from mraudio_tpu.models.xinstructblip import XInstructBLIP as JModel
from mraudio_tpu.text.postprocess import moment_str_to_list as j_parse
from mraudio_tpu.text.postprocess import post_process as j_post
from mraudio_tpu_torch.config import AudioFrontendConfig, slice_model_config, tiny_model_config
from mraudio_tpu_torch.infer.generate import prefill_cache
from mraudio_tpu_torch.models.casting import cast_params_for_inference
from mraudio_tpu_torch.models.convert_jax import load_jax_params_
from mraudio_tpu_torch.models.xinstructblip import GenerateBatch, XInstructBLIP
from mraudio_tpu_torch.text.postprocess import moment_str_to_list, post_process

torch.set_num_threads(1)

AUDIO = dict(num_mel_bins=16, mel_frames_per_chunk=32)
# bf16 on both sides, different rounding points (fused bias adds, GELU,
# RoPE products) through encoders + Q-Formers + 2 decoder layers; the
# observed max difference is one bf16 ulp of the largest logit (3.9e-3)
BF16_LOGIT_ATOL = 1e-2


def _slice(cfg, dtype):
    llm = cfg.llm.replace(kv_quant="int8", vocab_pad_multiple=8, attention_impl="pallas",
                          decode_gemv="pallas", prefill_chunk=0, dtype=dtype)
    return cfg.replace(llm=llm, vit=cfg.vit.replace(dtype=dtype),
                       beats=cfg.beats.replace(dtype=dtype),
                       qformer=cfg.qformer.replace(dtype=dtype))


def _refill(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _refill(v, rng)
            if "w_int8" in v:
                n = v["w_int8"].shape[1]
                out[k]["w_int8"] = rng.integers(-127, 128, v["w_int8"].shape).astype(np.int8)
                out[k]["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32) * (0.05 / 73.6)
        elif k == "lora_b":
            out[k] = (rng.standard_normal(v.shape) * 0.05).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _batch(b=3, t=4):
    rng = np.random.default_rng(0)
    return GenerateBatch(
        video=rng.integers(0, 256, (b, t, 28, 28, 3), dtype=np.uint8),
        audio=rng.integers(-4000, 4000, (b, 16000 * 3), dtype=np.int16),
        timestamps=np.tile(np.arange(t, dtype=np.int32) * 37, (b, 1)),
        duration=[150, 149, 120][:b],
        text_input=[f"Query: a person does thing {i}\nGiven the video and the query, "
                    "find the relevant windows.\nRelevant windows: " for i in range(b)],
    )


@pytest.fixture(scope="module")
def jax_params():
    """JAX's ``PRNGKey(0)`` init of the slice tree (compiled: the ~20 s eager
    init of many small ops is the slow part of this file), int8 weights
    and LoRA B refilled; the tree is the same at both dtypes."""
    jm = JModel(_slice(j_tiny(quantization="int8"), "float32"), audio_cfg=JAudioCfg(**AUDIO))
    return _refill(jax.device_get(jm.init_params(jax.random.PRNGKey(0), jit=True)),
                   np.random.default_rng(1))


def _pair(jax_params, dtype):
    jcfg = _slice(j_tiny(quantization="int8"), dtype)
    jm = JModel(jcfg, audio_cfg=JAudioCfg(**AUDIO))
    params = jax_params
    if dtype == "bfloat16":
        params = jax.device_get(j_cast(params))
    tcfg = _slice(tiny_model_config(quantization="int8"), dtype)
    assert tcfg.llm == slice_model_config(tcfg).llm
    tm = XInstructBLIP(tcfg, audio_cfg=AudioFrontendConfig(**AUDIO), device="cpu")
    load_jax_params_(tm, params)
    return jm, params, tm


def test_generate_f32_identical_strings_and_windows(jax_params):
    jm, params, tm = _pair(jax_params, "float32")
    batch = _batch()
    ref = jm.generate(params, batch)
    stats = {}
    out = tm.generate(batch=batch, stats=stats)
    assert out == ref
    assert [moment_str_to_list(post_process(o)) for o in out] == \
        [j_parse(j_post(o)) for o in ref]
    assert stats["decode_steps"] >= 1


def test_prefill_logits_bf16_within_tolerance(jax_params):
    jm, params, tm = _pair(jax_params, "bfloat16")
    for name, p in tm.named_parameters():
        assert p.dtype in (torch.bfloat16, torch.float32, torch.int8), name
    batch = _batch()
    n_frms = batch.timestamps.shape[1]
    text = jm.prepare_text(batch.text_input, batch.timestamps, batch.duration)
    j_embeds, j_mask = jm._prefix_and_prompt(
        params, jnp.asarray(batch.video), jnp.asarray(batch.audio),
        *(jnp.asarray(getattr(text, f)) for f in (
            "qformer_ids", "qformer_mask", "ts_ids", "ts_mask", "dur_ids", "dur_mask",
            "prompt_ids", "prompt_mask")),
        n_frms=n_frms)
    t_embeds, t_mask = tm.prefix_embeds(*tm.device_inputs(batch),
                                        tm.prepare_text(batch.text_input, batch.timestamps,
                                                        batch.duration), n_frms)
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    assert t_embeds.dtype == torch.bfloat16 and t_embeds.shape == j_embeds.shape

    b, s = j_mask.shape
    pos = np.maximum(np.cumsum(np.asarray(j_mask), -1) - 1, 0).astype(np.int32)
    full = np.zeros((b, s + 4), np.int32)
    full[:, :s] = np.asarray(j_mask)
    llm_params = {"params": params["llm"]}
    j_hidden, _ = j_prefill(jm.llm, llm_params, j_embeds, jnp.asarray(pos), jnp.asarray(full),
                            s + 4)
    j_logits = np.asarray(jm.llm.apply(llm_params, method=lambda m, h: m.logits(h),
                                       h=j_hidden[:, -1:]))
    with torch.inference_mode():
        t_hidden, _ = prefill_cache(tm.llm, t_embeds, torch.from_numpy(pos),
                                    torch.from_numpy(full), s + 4)
        t_logits = tm.llm.logits(t_hidden[:, -1:]).numpy()
    v = tm.cfg.llm.vocab_size
    assert np.all(np.isfinite(t_logits[..., :v]))
    np.testing.assert_allclose(t_logits[..., :v], j_logits[..., :v], rtol=0,
                               atol=BF16_LOGIT_ATOL)


@pytest.mark.parametrize("flag", ["saliency_head"])
def test_unported_options_raise(flag):
    """``saliency_head`` was refused until the training slice ported it: the
    model now builds the head; the LLM options refused until the
    quantized slice (``scan_layers``, an int4 cache, int4 weights,
    ``mlp_seq_chunk``) build too, and an unknown cache format raises."""
    cfg = tiny_model_config().replace(**{flag: True})
    model = XInstructBLIP(cfg, device="cpu")
    assert model.saliency_head.fc1.kernel.shape == (cfg.llm.hidden_size, 256)
    for llm in (cfg.llm.replace(scan_layers=True), cfg.llm.replace(kv_quant="int4"),
                cfg.llm.replace(quantization="int4", int4_group_size=32),
                cfg.llm.replace(mlp_seq_chunk=16)):
        built = XInstructBLIP(cfg.replace(llm=llm), device="cpu")
        assert built.llm.cfg == llm
    assert built.llm.layers[0].mlp.cfg.mlp_seq_chunk == 16
    with pytest.raises(ValueError, match="kv_quant"):
        XInstructBLIP(cfg.replace(llm=cfg.llm.replace(kv_quant="int2")), device="cpu")


def test_cast_params_matches_jax_rule():
    """The port's cast gives every parameter the dtype the JAX package's
    cast gives the same leaf (a fill of the init's shapes and dtypes
    suffices: the rule reads names and dtypes only)."""
    from test_torch_convert_weights import _fill

    jcfg = _slice(j_tiny(quantization="int8"), "float32")
    jm = JModel(jcfg, audio_cfg=JAudioCfg(**AUDIO))
    params = _fill(jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0), jit=False)), 0.5)
    ref = XInstructBLIP(_slice(tiny_model_config(quantization="int8"), "float32"),
                        audio_cfg=AudioFrontendConfig(**AUDIO), device="cpu")
    load_jax_params_(ref, jax.device_get(j_cast(params)))
    tm = XInstructBLIP(_slice(tiny_model_config(quantization="int8"), "float32"),
                       audio_cfg=AudioFrontendConfig(**AUDIO), device="cpu")
    cast_params_for_inference(load_jax_params_(tm, params))
    want = {n: p.dtype for n, p in ref.named_parameters()}
    got = {n: p.dtype for n, p in tm.named_parameters()}
    assert got == want
    assert want["llm.layers.0.attn.q_proj.w_int8"] == torch.int8
    assert want["vit.blocks.0.norm1.bias"] == torch.float32
    assert want["vit.blocks.0.attn.q.bias"] == torch.bfloat16
