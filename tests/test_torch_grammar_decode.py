"""The port's speculative decoders against the JAX package: the span
grammar's tables, ``chunked_attention``'s per-row columns (``q_abs``),
the per-row cache write, ``grammar_generate``, ``lookup_draft`` and
``lookup_generate``.

Tolerances: ``chunked_attention`` within 1e-5 of JAX's in f32 (the two
take their f32 sums in other orders); everything else exact — the
grammar tables, the cache after a speculative pass (its inputs are
integers, so the projections are exact in any order) and every token.
The exactness contracts of the reference hold in the port too: grammar
decoding at ``spec_width=4`` gives the tokens of ``spec_width=1`` (f32
and bf16), and lookup decoding gives greedy's tokens."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mraudio_tpu.config import LlamaConfig as JLlamaConfig
from mraudio_tpu.config import LoraConfig as JLoraConfig
from mraudio_tpu.infer.generate import grammar_generate as j_grammar
from mraudio_tpu.infer.generate import lookup_draft as j_lookup_draft
from mraudio_tpu.infer.generate import lookup_generate as j_lookup
from mraudio_tpu.models.llama import LlamaAttention as JAttention
from mraudio_tpu.models.llama import LlamaModel as JLlama
from mraudio_tpu.ops.attention import chunked_attention as j_chunked
from mraudio_tpu.text.grammar import char_accepts as j_char_accepts
from mraudio_tpu.text.grammar import compile_grammar as j_compile
from mraudio_tpu.text.tokenizer import ByteTokenizer as JByteTokenizer
from mraudio_tpu_torch.config import LlamaConfig, LoraConfig
from mraudio_tpu_torch.infer.generate import (grammar_generate, greedy_generate, lookup_draft,
                                              lookup_generate)
from mraudio_tpu_torch.models.convert_jax import load_jax_params_
from mraudio_tpu_torch.models.llama import LlamaAttention, LlamaModel, init_cache
from mraudio_tpu_torch.ops.attention import chunked_attention
from mraudio_tpu_torch.text.grammar import char_accepts, compile_grammar
from mraudio_tpu_torch.text.tokenizer import ByteTokenizer

torch.set_num_threads(1)

B, S, EOS = 3, 12, 2
BASE = dict(vocab_size=260, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=4,
            intermediate_size=128, max_seq_len=256, dtype="float32", prefill_chunk=0,
            quantization="int8", kv_quant="int8")
TABLES = ("allowed", "next_state", "forced", "dist_next")


def _refill(tree, rng):
    """The flax init leaves int8 weights at 0 and LoRA's B at 0."""
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


@pytest.fixture(scope="module")
def llm():
    """JAX model, numpy params and inputs (three rows, two left-padded)."""
    jm = JLlama(JLlamaConfig(**BASE), JLoraConfig(rank=2, alpha=2))
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 64)),
                                    jnp.ones((1, 1, 8, 8), bool), jnp.zeros((1, 8), jnp.int32),
                                    jnp.zeros((1, 8), jnp.int32),
                                    method=JLlama.init_all)["params"])
    params = _refill(params, np.random.default_rng(0))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, 64)).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[1, :3] = 0
    mask[2, :5] = 0
    return jm, params, x, mask


def _port(params, **changes):
    cfg = LlamaConfig(**dict(BASE, **changes))
    return load_jax_params_(LlamaModel(cfg, LoraConfig(rank=2, alpha=2)), params)


@pytest.fixture(scope="module")
def tables():
    t = compile_grammar(ByteTokenizer(260), allow_float=False)
    return {name: torch.from_numpy(getattr(t, name)) for name in TABLES}


# ------------------------------------------------------------------ grammar

@pytest.mark.parametrize("vocab", [260, 32001])
@pytest.mark.parametrize("allow_float", [False, True])
def test_grammar_tables_match_jax(vocab, allow_float):
    ref = j_compile(JByteTokenizer(vocab), allow_float=allow_float)
    got = compile_grammar(ByteTokenizer(vocab), allow_float=allow_float)
    for name in TABLES:
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name), err_msg=name)
    assert (got.eos_id, got.terminal_state, got.done_state) == (
        ref.eos_id, ref.terminal_state, ref.done_state)


def test_char_accepts_matches_jax():
    cases = ["[[1, 2]]", " [[0, 10], [3, 45]]", "[[1.5, 2]]", "[[01, 2]]", "[[1, 2]",
             "[[1234567, 2]]", "[[1,2]]", "", "[[0.25, 100.0]]"]
    for text in cases:
        for allow_float in (False, True):
            assert char_accepts(text, allow_float) == j_char_accepts(text, allow_float), text


# -------------------------------------------------- per-row chunked attention

def _int8_cache(rng, b, kv, h, d):
    from mraudio_tpu_torch.models.llama import quantize_kv

    kq, ks = quantize_kv(torch.from_numpy(rng.standard_normal((b, kv, h, d)).astype(np.float32)))
    vq, vs = quantize_kv(torch.from_numpy(rng.standard_normal((b, kv, h, d)).astype(np.float32)))
    return kq, vq, ks.transpose(1, 2).contiguous(), vs.transpose(1, 2).contiguous()


@pytest.mark.parametrize("w", [1, 4])
def test_chunked_attention_q_abs_matches_jax(w):
    """Rows at ragged columns over an int8 cache of a full 512-key chunk
    plus a ragged tail; f32, within 1e-5 of JAX's ``q_abs`` route."""
    rng = np.random.default_rng(4)
    b, kv, h, d = 3, 700, 2, 32
    kq, vq, ks, vs = _int8_cache(rng, b, kv, h, d)
    q = rng.standard_normal((b, w, h, d)).astype(np.float32)
    starts = np.array([300, 601, 690 - w], np.int64)
    q_abs = starts[:, None] + np.arange(w)[None]
    mask = (np.arange(kv)[None] <= q_abs[:, -1:]).astype(np.int32)
    mask[0, 40:60] = 0
    kw = dict(causal=True, kv_bshd=True, q_bshd=True, scales_bhs=True)
    ref = j_chunked(jnp.asarray(q), jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()),
                    jnp.asarray(mask), unroll_q=True, k_scale=jnp.asarray(ks.numpy()),
                    v_scale=jnp.asarray(vs.numpy()), q_abs=jnp.asarray(q_abs), **kw)
    out = chunked_attention(torch.from_numpy(q), kq, vq, torch.from_numpy(mask),
                            k_scale=ks, v_scale=vs, q_abs=torch.from_numpy(q_abs), **kw)
    assert out.shape == (b, w, h, d)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_q_abs_at_a_shared_column_is_the_q_offset_route():
    """All rows at one column: the per-row route gives the bits of the
    static-offset route, at 4 queries and at 1 (both padded to 16 rows)."""
    rng = np.random.default_rng(5)
    b, kv, h, d = 2, 1100, 2, 32
    kq, vq, ks, vs = _int8_cache(rng, b, kv, h, d)
    mask = torch.ones((b, kv), dtype=torch.int32)
    kw = dict(causal=True, kv_bshd=True, q_bshd=True, scales_bhs=True, k_scale=ks, v_scale=vs)
    for w, col in ((4, 700), (1, 1099)):
        q = torch.from_numpy(rng.standard_normal((b, w, h, d)).astype(np.float32))
        q_abs = torch.arange(col, col + w)[None].expand(b, w)
        per_row = chunked_attention(q, kq, vq, mask, q_abs=q_abs, **kw)
        shared = chunked_attention(q, kq, vq, mask, q_offset=col, **kw)
        assert torch.equal(per_row, shared), (w, col)


def test_speculative_pass_cache_matches_jax():
    """One per-row pass of a decoder layer over an int8 cache: the values
    and scales written at each row's columns equal JAX's, and no other
    column changes.  Integer inputs, integer weights with a power-of-two
    scale and RoPE at position 0 make the projections exact."""
    rng = np.random.default_rng(6)
    cfg = dict(BASE, hidden_size=32, num_heads=2, num_kv_heads=2)
    b, w, kv, dm = 3, 4, 40, 32
    jattn = JAttention(JLlamaConfig(**cfg), None)
    x = rng.integers(-3, 4, (b, w, dm)).astype(np.float32)
    params = jax.device_get(jattn.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                       jnp.ones((b, 1, w, w), bool),
                                       jnp.zeros((b, w), jnp.int32))["params"])
    params = {name: {"w_int8": rng.integers(-127, 128, p["w_int8"].shape).astype(np.int8),
                     "scale": np.full(p["scale"].shape, 2.0 ** -7, np.float32)}
              for name, p in params.items()}
    cache = {"k": rng.integers(-127, 128, (b, kv, 2, 16)).astype(np.int8),
             "v": rng.integers(-127, 128, (b, kv, 2, 16)).astype(np.int8),
             "k_scale": rng.uniform(0.01, 0.1, (b, 2, kv)).astype(np.float32),
             "v_scale": rng.uniform(0.01, 0.1, (b, 2, kv)).astype(np.float32)}
    index = np.array([10, 17, 30], np.int64)
    cols = index[:, None] + np.arange(w)
    valid = (np.arange(kv)[None] <= cols[:, -1:]).astype(np.int32)
    mask4 = valid[:, None, None, :].astype(bool) & (np.arange(kv)[None, None, None, :]
                                                    <= cols[:, None, :, None])
    positions = np.zeros((b, w), np.int32)
    j_out, j_cache = jattn.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask4),
                                 jnp.asarray(positions),
                                 cache={k: jnp.asarray(v) for k, v in cache.items()},
                                 cache_index=jnp.asarray(index), kv_valid=jnp.asarray(valid),
                                 causal=True)
    tattn = load_jax_params_(LlamaAttention(LlamaConfig(**cfg), None), params)
    t_cache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    t_out, t_cache = tattn(torch.from_numpy(x), torch.from_numpy(mask4),
                           torch.from_numpy(positions), cache=t_cache,
                           cache_index=torch.from_numpy(index), kv_valid=torch.from_numpy(valid),
                           causal=True)
    written = np.zeros((b, kv), bool)
    written[np.arange(b)[:, None], cols] = True
    for name in ("k", "v", "k_scale", "v_scale"):
        got, want = t_cache[name].numpy(), np.asarray(j_cache[name])
        np.testing.assert_array_equal(got, want, err_msg=name)
        keep = ~written if name in ("k", "v") else ~written[:, None, :].repeat(2, 1)
        np.testing.assert_array_equal(got[keep], cache[name][keep], err_msg=name)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ grammar decode

def _decoded_ok(tokens):
    tok = ByteTokenizer(260)
    return all(char_accepts(tok.decode(row).strip(), allow_float=False) for row in tokens)


@pytest.mark.parametrize("w", [1, 4])
def test_grammar_tokens_match_jax(llm, tables, w):
    jm, params, x, mask = llm
    max_new = 20
    jt = {name: jnp.asarray(tables[name].numpy()) for name in TABLES}
    ref = np.asarray(j_grammar(jm, {"params": params}, jnp.asarray(x), jnp.asarray(mask),
                               max_new, EOS, jt["allowed"], jt["next_state"], jt["forced"],
                               jt["dist_next"], spec_width=w))
    stats = {}
    got = grammar_generate(_port(params), torch.from_numpy(x), torch.from_numpy(mask), max_new,
                           EOS, *(tables[name] for name in TABLES), spec_width=w, stats=stats)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert _decoded_ok(ref), [ByteTokenizer(260).decode(r) for r in ref]
    assert len(stats["decode_tokens"]) == B and stats["decode_steps"] >= 1
    assert stats["prefill_segments"] == 1 and stats["prefill_logits"].shape == (B, 260)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grammar_spec_width_is_token_identical(llm, tables, dtype):
    _, params, x, mask = llm
    model = _port(params, dtype=dtype)
    runs = {}
    for w in (1, 4):
        stats = {}
        tokens = grammar_generate(model, torch.from_numpy(x), torch.from_numpy(mask), 20, EOS,
                                  *(tables[name] for name in TABLES), spec_width=w, stats=stats)
        runs[w] = tokens, stats
    assert torch.equal(runs[4][0], runs[1][0])
    # every pass commits at least one token; forced runs share a pass (a
    # draft may also commit the forced EOS tokens after the end, so the
    # committed counts are not compared)
    assert runs[4][1]["decode_steps"] < runs[1][1]["decode_steps"]
    assert _decoded_ok(runs[4][0].numpy())


# ---------------------------------------------------------------- lookup

def test_lookup_draft_matches_jax():
    """History wins over hints; hints are the cold-start source; repeat
    ``cur`` otherwise; padded hint columns never match."""
    w, length = 4, 8
    tokens = np.full((3, length), 2, np.int32)
    tokens[0, :3] = [5, 6, 7]
    emitted = np.array([3, 0, 0], np.int64)
    cur = np.array([5, 5, 5], np.int32)
    hint_ids = np.array([[1, 5, 3, 3, 3, 3], [1, 1, 5, 9, 8, 7], [1, 1, 1, 1, 1, 1]], np.int32)
    hint_mask = np.ones((3, 6), np.int32)
    hint_mask[1, 5] = 0
    hint_mask2 = hint_mask.copy()
    hint_mask2[1, 2] = 0
    for hm, want in ((hint_mask, [[6, 7, 5], [9, 8, 5], [5, 5, 5]]),
                     (hint_mask2, [[6, 7, 5], [5, 5, 5], [5, 5, 5]]),
                     (None, [[6, 7, 5], [9, 8, 7], [5, 5, 5]])):
        ref = np.asarray(j_lookup_draft(jnp.asarray(tokens), jnp.asarray(emitted),
                                        jnp.asarray(cur), w, jnp.asarray(hint_ids),
                                        None if hm is None else jnp.asarray(hm)))
        got = lookup_draft(torch.from_numpy(tokens), torch.from_numpy(emitted),
                           torch.from_numpy(cur), w, torch.from_numpy(hint_ids),
                           None if hm is None else torch.from_numpy(hm))
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(ref, want)


@pytest.mark.parametrize("w", [2, 4])
def test_lookup_matches_greedy_and_jax(llm, w):
    jm, params, x, mask = llm
    model = _port(params)
    hints = torch.from_numpy(np.tile(np.arange(3, 23, dtype=np.int32), (B, 1)))
    for max_new in (8, 24):
        base = greedy_generate(model, torch.from_numpy(x), torch.from_numpy(mask), max_new, EOS)
        stats = {}
        spec = lookup_generate(model, torch.from_numpy(x), torch.from_numpy(mask), max_new, EOS,
                               spec_width=w, hint_ids=hints, stats=stats)
        ref = np.asarray(j_lookup(jm, {"params": params}, jnp.asarray(x), jnp.asarray(mask),
                                  max_new, EOS, spec_width=w, hint_ids=jnp.asarray(hints.numpy())))
        assert torch.equal(spec, base), max_new
        np.testing.assert_array_equal(spec.numpy(), ref)
        assert 1 <= stats["decode_steps"] <= max_new


def test_cache_is_allocated_with_the_widest_draft(llm, tables, monkeypatch):
    """Every decoder writes the same number of cache columns (the prefix,
    the budget and one widest draft), so their attention tiles agree."""
    from mraudio_tpu_torch.infer import generate

    _, params, x, _ = llm
    model = _port(params)
    seen = []

    def spy(cfg, batch, max_len, device="cuda"):
        seen.append(max_len)
        return init_cache(cfg, batch, max_len, device)

    monkeypatch.setattr(generate, "init_cache", spy)
    xs, ms = torch.from_numpy(x), torch.ones((B, S), dtype=torch.int32)
    greedy_generate(model, xs, ms, 4, EOS)
    lookup_generate(model, xs, ms, 4, EOS, spec_width=3)
    grammar_generate(model, xs, ms, 4, EOS, *(tables[name] for name in TABLES), spec_width=2)
    assert seen == [S + 4 + generate.MAX_SPEC_WIDTH] * 3
