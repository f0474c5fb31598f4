"""SnapKV compaction (``LlamaConfig.kv_keep``) in the port against the JAX
package: the prefill's observation-window scores, ``compact_cache``'s
selection and gather, and the three offline decoders over a compacted
cache.

Tolerances: ``obs_score`` within 1e-5 of JAX's (f32 softmax rows summed in
another order); everything else exact — the kept columns and the gathered
int8 values, scales and ``valid`` leaves (the selection is fed identical
scores, ties included), and every token.  Keeping at least the whole
prefix keeps every column in order, so the decoders must give the tokens
of the uncompacted run."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mraudio_tpu.config import LlamaConfig as JLlamaConfig
from mraudio_tpu.infer.generate import greedy_generate as j_greedy
from mraudio_tpu.infer.generate import prefill_cache as j_prefill_cache
from mraudio_tpu.models.llama import LlamaModel as JLlama
from mraudio_tpu.models.llama import compact_cache as j_compact_cache
from mraudio_tpu_torch.config import LlamaConfig
from mraudio_tpu_torch.infer.generate import (grammar_generate, greedy_generate,
                                              lookup_generate, prefill_cache)
from mraudio_tpu_torch.models.convert_jax import load_jax_params_
from mraudio_tpu_torch.models.llama import LlamaModel, compact_cache
from mraudio_tpu_torch.text.grammar import compile_grammar
from mraudio_tpu_torch.text.tokenizer import ByteTokenizer

torch.set_num_threads(1)

B, S, EOS, NEW = 3, 20, 2, 8
BASE = dict(vocab_size=260, hidden_size=64, num_layers=2, num_heads=8, num_kv_heads=8,
            intermediate_size=128, max_seq_len=256, dtype="float32", prefill_chunk=0,
            quantization="int8", kv_quant="int8", kv_keep_obs=6, kv_keep_sink=2)
TABLES = ("allowed", "next_state", "forced", "dist_next")


def _refill(tree, rng):
    """The flax init leaves int8 weights at 0."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _refill(v, rng)
            if "w_int8" in v:
                n = v["w_int8"].shape[1]
                out[k]["w_int8"] = rng.integers(-127, 128, v["w_int8"].shape).astype(np.int8)
                out[k]["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32) * (0.05 / 73.6)
        else:
            out[k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def llm():
    """JAX params and inputs: row 0 full, row 1 left-padded, row 2 with
    interior padding and a padded observation query."""
    jm = JLlama(JLlamaConfig(**BASE), None)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 64)),
                                    jnp.ones((1, 1, 8, 8), bool), jnp.zeros((1, 8), jnp.int32),
                                    jnp.zeros((1, 8), jnp.int32),
                                    method=JLlama.init_all)["params"])
    params = _refill(params, np.random.default_rng(0))
    x = np.random.default_rng(1).standard_normal((B, S, 64)).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[1, :4] = 0
    mask[2, 6:9] = 0
    mask[2, S - 3] = 0
    return params, x, mask


def _jax(**changes):
    return JLlama(JLlamaConfig(**dict(BASE, **changes)), None)


def _port(params, **changes):
    return load_jax_params_(LlamaModel(LlamaConfig(**dict(BASE, **changes))), params)


def _prefill_inputs(mask, alloc):
    positions = np.maximum(np.cumsum(mask, -1) - 1, 0).astype(np.int32)
    full = np.zeros((B, alloc), np.int32)
    full[:, :S] = mask
    return positions, full


@pytest.mark.parametrize("chunk", [0, 7])
def test_obs_score_matches_jax(llm, chunk):
    """One shot and in three segments (7 + 7 + 6, the window of 6 queries
    split across the last two): every layer's scores within 1e-5 of JAX's,
    and the segmented scores within 1e-5 of the one-shot ones."""
    params, x, mask = llm
    alloc = S + 4
    positions, full = _prefill_inputs(mask, alloc)
    ref = {}
    for c in (0, chunk):
        _, cache = j_prefill_cache(_jax(kv_keep=10, prefill_chunk=c), {"params": params},
                                   jnp.asarray(x), jnp.asarray(positions), jnp.asarray(full),
                                   alloc)
        ref[c] = [np.asarray(layer["obs_score"]) for layer in cache]
    with torch.inference_mode():
        _, cache = prefill_cache(_port(params, kv_keep=10, prefill_chunk=chunk),
                                 torch.from_numpy(x), torch.from_numpy(positions),
                                 torch.from_numpy(full), alloc)
    for layer, want, one_shot in zip(cache, ref[chunk], ref[0]):
        got = layer["obs_score"].numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, one_shot, rtol=1e-5, atol=1e-5)
    # every valid observation query spreads one unit of mass per head
    h, valid_obs = BASE["num_heads"], mask[:, S - 6:].sum(-1)
    np.testing.assert_allclose(cache[0]["obs_score"].sum(-1).numpy(), valid_obs * h, rtol=1e-5)


@pytest.mark.parametrize("keep", [10, 13, S])
def test_compact_cache_matches_jax_with_ties(keep):
    """The same cache and scores through both ``compact_cache``s: kept
    columns, values, scales and ``valid`` leaves identical.  The scores
    take four values, so most selections fall on ties; invalid columns
    tie at the bottom and the protected ones at the top."""
    rng = np.random.default_rng(2)
    kv, h, d, extra = S + 5, 2, 8, 9
    cfg = dict(BASE, num_heads=h, num_kv_heads=h, hidden_size=h * d, kv_keep=keep)
    valid = np.zeros((B, kv), np.int32)
    valid[:, :S] = 1
    valid[1, :5] = 0
    valid[2, 3:12] = 0
    layers = [{"k": rng.integers(-127, 128, (B, kv, h, d)).astype(np.int8),
               "v": rng.integers(-127, 128, (B, kv, h, d)).astype(np.int8),
               "k_scale": rng.uniform(0.01, 0.1, (B, h, kv)).astype(np.float32),
               "v_scale": rng.uniform(0.01, 0.1, (B, h, kv)).astype(np.float32),
               "obs_score": rng.integers(0, 4, (B, kv)).astype(np.float32)} for _ in range(2)]
    ref = j_compact_cache(JLlamaConfig(**cfg), [{k: jnp.asarray(v) for k, v in lay.items()}
                                                for lay in layers],
                          jnp.asarray(valid), S, extra)
    got = compact_cache(LlamaConfig(**cfg), [{k: torch.from_numpy(v.copy())
                                              for k, v in lay.items()} for lay in layers],
                        torch.from_numpy(valid), S, extra)
    for want, have in zip(ref, got):
        assert sorted(have) == sorted(want) == ["k", "k_scale", "v", "v_scale", "valid"]
        for name in want:
            np.testing.assert_array_equal(have[name].numpy(), np.asarray(want[name]),
                                          err_msg=name)
        assert have["valid"].shape == (B, min(keep, S) + extra)


def test_greedy_kv_keep_matches_jax(llm):
    """Greedy decoding over a cache compacted to 10 of 20 columns: the
    port's tokens are JAX's."""
    params, x, mask = llm
    ref = np.asarray(j_greedy(_jax(kv_keep=10), {"params": params}, jnp.asarray(x),
                              jnp.asarray(mask), NEW, EOS))
    got = greedy_generate(_port(params, kv_keep=10), torch.from_numpy(x),
                          torch.from_numpy(mask), NEW, EOS)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("decoder", ["greedy", "grammar", "lookup"])
def test_keep_whole_prefix_matches_uncompacted(llm, decoder):
    """``kv_keep`` >= the prefix keeps every column in order (the surplus
    budget stays unused): each decoder gives the uncompacted tokens."""
    params, x, mask = llm
    xs, ms = torch.from_numpy(x), torch.from_numpy(mask)
    tables = compile_grammar(ByteTokenizer(260), allow_float=False)

    def run(model):
        if decoder == "greedy":
            return greedy_generate(model, xs, ms, NEW, EOS)
        if decoder == "lookup":
            return lookup_generate(model, xs, ms, NEW, EOS, spec_width=4)
        return grammar_generate(model, xs, ms, 16, EOS,
                                *(torch.from_numpy(getattr(tables, n)) for n in TABLES),
                                spec_width=4)

    base = run(_port(params))
    for keep in (S, S + 7):
        assert torch.equal(run(_port(params, kv_keep=keep)), base), keep
