"""The port's segmented prefill (``LlamaConfig.prefill_chunk``), mirroring
``tests/test_prefill_chunk.py``: greedy tokens are identical for
``prefill_chunk`` 0, 8 and 10 (10 leaves an uneven last segment of 4),
with a left-padded row, a model-dtype and an int8 KV cache, and
``attention_impl`` "chunked" (every segment through ``chunked_attention``)
and "pallas" (segment 0 through flash's plain version, later segments
through ``chunked_attention``) — and identical to the JAX package's
``greedy_generate`` on the same weights, in f32."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mraudio_tpu.config import LlamaConfig as JLlamaConfig
from mraudio_tpu.config import LoraConfig as JLoraConfig
from mraudio_tpu.infer.generate import greedy_generate as j_greedy
from mraudio_tpu.models.llama import LlamaModel as JLlama
from mraudio_tpu_torch.config import LlamaConfig, LoraConfig
from mraudio_tpu_torch.infer.generate import greedy_generate
from mraudio_tpu_torch.models.convert_jax import load_jax_params_
from mraudio_tpu_torch.models.llama import LlamaModel

torch.set_num_threads(1)

S, MAX_NEW = 24, 6
BASE = dict(vocab_size=260, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=4,
            intermediate_size=128, max_seq_len=256, dtype="float32", prefill_chunk=0)
VARIANTS = {
    "plain": dict(quantization="none", kv_quant="none"),
    "int8kv": dict(quantization="int8", kv_quant="int8"),
}


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


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def variant(request):
    """(name, JAX tokens with a one-shot chunked prefill, numpy params,
    inputs)."""
    kw = dict(BASE, **VARIANTS[request.param])
    jm = JLlama(JLlamaConfig(**kw), JLoraConfig(rank=2, alpha=2))
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 64)),
                                    jnp.ones((1, 1, 8, 8), bool), jnp.zeros((1, 8), jnp.int32),
                                    jnp.zeros((1, 8), jnp.int32),
                                    method=JLlama.init_all)["params"])
    params = _refill(params, np.random.default_rng(0))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, S, 64)).astype(np.float32)
    mask = np.ones((2, S), np.int32)
    mask[1, :3] = 0                 # left padding, invisible in every segment
    ref = np.asarray(j_greedy(jm, {"params": params}, jnp.asarray(x), jnp.asarray(mask),
                              MAX_NEW, eos_id=2))
    return request.param, ref, params, x, mask


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_tokens_identical_across_chunks_and_to_jax(variant, impl):
    name, ref, params, x, mask = variant
    assert len(set(ref.ravel().tolist())) > 1, "reference tokens must not be constant"
    for chunk, segments in ((0, 1), (8, 3), (10, 3)):
        cfg = LlamaConfig(**dict(BASE, **VARIANTS[name], attention_impl=impl,
                                 prefill_chunk=chunk))
        tm = load_jax_params_(LlamaModel(cfg, LoraConfig(rank=2, alpha=2)), params)
        stats = {}
        got = greedy_generate(tm, torch.from_numpy(x), torch.from_numpy(mask), MAX_NEW,
                              eos_id=2, stats=stats)
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=f"{impl} chunk={chunk}")
        assert stats["prefill_segments"] == segments
