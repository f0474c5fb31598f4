"""Port parity for the decoder: LlamaModel forward, prefill into the KV
cache, and greedy decoding, on a tiny f32 config with both kernel routes
switched on (attention_impl="pallas", decode_gemv="pallas",
prefill_chunk=0).

On the CPU the JAX package interprets the GEMV and falls back to
``chunked_attention`` for the prefill, folding the int8 cache scales into
the logits; the port dequantizes the cache and runs the plain flash
version.  The two differ only in rounding."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mraudio_tpu.config import LlamaConfig as JLlamaConfig
from mraudio_tpu.config import LoraConfig as JLoraConfig
from mraudio_tpu.infer.generate import greedy_generate as j_greedy
from mraudio_tpu.infer.generate import prefill_cache as j_prefill
from mraudio_tpu.models.layers import positions_from_mask as j_positions
from mraudio_tpu.models.llama import LlamaModel as JLlama
from mraudio_tpu_torch.config import LlamaConfig, LoraConfig
from mraudio_tpu_torch.infer.generate import greedy_generate, prefill_cache
from mraudio_tpu_torch.models.convert_jax import load_jax_params_
from mraudio_tpu_torch.models.llama import LlamaModel
from mraudio_tpu_torch.ops.attention import flash_attention
from mraudio_tpu_torch.ops.gemv import decode_gemv

torch.set_num_threads(1)

CASES = {
    # the slice: int8 weights, int8 KV, padded vocab, random LoRA
    "int8": dict(quantization="int8", kv_quant="int8", vocab_pad_multiple=8),
    # float weights through the GEMV's float path, model-dtype cache
    "float": dict(quantization="none", kv_quant="none"),
}
BASE = dict(vocab_size=260, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=4,
            intermediate_size=128, max_seq_len=256, dtype="float32",
            attention_impl="pallas", decode_gemv="pallas", prefill_chunk=0)


def _refill(tree, rng, lora_b: bool):
    """Seeded non-zero int8 weights (scales for N(0, 0.02)-sized weights)
    and, optionally, non-zero LoRA B: the flax init leaves both zero."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _refill(v, rng, lora_b)
            if "w_int8" in v:
                n = v["w_int8"].shape[1]
                out[k]["w_int8"] = rng.integers(-127, 128, v["w_int8"].shape).astype(np.int8)
                out[k]["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32) * (0.05 / 73.6)
        elif k == "lora_b" and lora_b:
            out[k] = (rng.standard_normal(v.shape) * 0.05).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _models(case):
    kw = dict(BASE, **CASES[case])
    jcfg, tcfg = JLlamaConfig(**kw), LlamaConfig(**kw)
    jlora, tlora = JLoraConfig(rank=2, alpha=2), LoraConfig(rank=2, alpha=2)
    jm = JLlama(jcfg, jlora)
    s, d = 8, jcfg.hidden_size
    x = jnp.zeros((1, s, d))
    mask = jnp.ones((1, 1, s, s), bool)
    pos = jnp.zeros((1, s), jnp.int32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), x, mask, pos,
                                    jnp.zeros((1, s), jnp.int32),
                                    method=JLlama.init_all)["params"])
    params = _refill(params, np.random.default_rng(0), lora_b=case == "int8")
    tm = load_jax_params_(LlamaModel(tcfg, tlora), params)
    return jm, {"params": params}, tm


def _inputs(b=3, s=40, d=64):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    mask = np.ones((b, s), np.int32)
    mask[0, :5] = 0            # left padding
    mask[1, 12:17] = 0         # interior (timestamp-slot) padding
    return x, mask


@pytest.mark.parametrize("case", sorted(CASES))
def test_llama_forward_matches(case):
    jm, params, tm = _models(case)
    x, mask01 = _inputs()
    s = x.shape[1]
    attend = np.tril(np.ones((s, s), bool))[None, None] & mask01[:, None, None, :].astype(bool)
    pos = np.array(j_positions(jnp.asarray(mask01)))
    ref, _ = jm.apply(params, jnp.asarray(x), jnp.asarray(attend), jnp.asarray(pos))
    out, _ = tm(torch.from_numpy(x), torch.from_numpy(attend), torch.from_numpy(pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_and_greedy_match(case):
    jm, params, tm = _models(case)
    x, mask01 = _inputs()
    b, s, _ = x.shape
    new = 6
    alloc = s + new
    pos = np.maximum(np.cumsum(mask01, -1) - 1, 0).astype(np.int32)
    full = np.zeros((b, alloc), np.int32)
    full[:, :s] = mask01

    j_hidden, _ = j_prefill(jm, params, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(full), alloc)
    j_logits = jm.apply(params, method=lambda m, h: m.logits(h), h=j_hidden[:, -1:])
    t_hidden, cache = prefill_cache(tm, torch.from_numpy(x), torch.from_numpy(pos),
                                    torch.from_numpy(full), alloc)
    t_logits = tm.logits(t_hidden[:, -1:])
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), rtol=1e-4, atol=1e-4)
    if case == "int8":
        assert set(cache[0]) == {"k", "v", "k_scale", "v_scale"}
        assert cache[0]["k"].dtype == torch.int8 and cache[0]["k_scale"].shape == (b, 4, alloc)
        assert np.all(t_logits.numpy()[..., 260:] == np.finfo(np.float32).min)

    j_tokens = j_greedy(jm, params, jnp.asarray(x), jnp.asarray(mask01), new, eos_id=2)
    launches = (flash_attention.launches, decode_gemv.launches)
    stats = {}
    t_tokens = greedy_generate(tm, torch.from_numpy(x), torch.from_numpy(mask01), new,
                               eos_id=2, stats=stats)
    np.testing.assert_array_equal(t_tokens.numpy(), np.asarray(j_tokens))
    assert 1 <= stats["decode_steps"] <= new
    # CPU tensors ran the plain versions: nothing was launched
    assert (flash_attention.launches, decode_gemv.launches) == launches == (0, 0)
