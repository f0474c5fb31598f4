"""The port's int4 formats and W8A8 against the JAX package: the nibble
packing, the int4 KV cache, the group-wise int4 weights and ``int8_dot``.

Packing and quantization are integer and rounding arithmetic both
packages do alike, so they are compared bit for bit.  The int4
projection is compared at 1e-5 relative: both take f32 operands on the
CPU, and torch's matmul and XLA's dot sum a group's products in other
orders.  W8A8 is bit-exact in bf16: the int8 product is exact in int32
and the rescale is the same three f32 operations.  Greedy decoding with
int4 weights, an int4 cache and both gives JAX's tokens, on the decoder
and through both backbones' ``generate``; the serving engine with an
int4 cache under ``kv_keep`` gives the offline decoder's tokens."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mraudio_tpu.config import LlamaConfig as JLlamaConfig
from mraudio_tpu.infer.generate import greedy_generate as j_greedy
from mraudio_tpu.models import convert_weights as jcw
from mraudio_tpu.models.llama import LlamaLinear as JLinear
from mraudio_tpu.models.llama import LlamaModel as JLlama
from mraudio_tpu.models.llama import quantize_kv4 as j_quantize_kv4
from mraudio_tpu.ops.attention import chunked_attention as j_chunked
from mraudio_tpu.ops.attention import pack_int4 as j_pack
from mraudio_tpu.ops.attention import unpack_int4 as j_unpack
from mraudio_tpu_torch.config import LlamaConfig
from mraudio_tpu_torch.infer.generate import greedy_generate
from mraudio_tpu_torch.infer.serving import ContinuousBatcher, Request
from mraudio_tpu_torch.models import convert_weights as tcw
from mraudio_tpu_torch.models.convert_jax import flax_params, init_random_, load_jax_params_
from mraudio_tpu_torch.models.llama import LlamaLinear, LlamaModel, init_cache, quantize_kv4
from mraudio_tpu_torch.ops.attention import chunked_attention, pack_int4, unpack_int4
from test_torch_serving import NEW, S, _check_greedy, _drive, _prefixes
from test_torch_train_loss import jax_tree

torch.set_num_threads(1)

BASE = dict(vocab_size=260, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=4,
            intermediate_size=128, max_seq_len=256, dtype="float32", prefill_chunk=0,
            int4_group_size=32)
FORMATS = {"int4_kv": dict(quantization="int8", kv_quant="int4"),
           "int4_weights": dict(quantization="int4", kv_quant="int8"),
           "int4_both": dict(quantization="int4", kv_quant="int4")}


def test_pack_unpack_all_bytes():
    every = np.arange(256, dtype=np.uint8).reshape(16, 16)
    theirs = np.asarray(j_unpack(jnp.asarray(every)))
    ours = unpack_int4(torch.from_numpy(every)).numpy()
    np.testing.assert_array_equal(ours, theirs)
    # every nibble pair in [-8, 7]² packs to its byte, in both packages
    assert ours.min() == -8 and ours.max() == 7
    np.testing.assert_array_equal(pack_int4(torch.from_numpy(ours)).numpy(), every)
    np.testing.assert_array_equal(np.asarray(j_pack(jnp.asarray(ours))), every)


def test_quantize_kv4_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    x[0, 3] = 0.0                                   # an all-zero head row: scale 1
    q, scale = quantize_kv4(torch.from_numpy(x))
    jq, jscale = j_quantize_kv4(jnp.asarray(x))
    assert q.dtype == torch.uint8 and q.shape == (2, 7, 4, 8)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    assert unpack_int4(q).min() >= -7               # clipped to ±7, -8 never written


def test_quantize_llama_int4_matches_jax():
    rng = np.random.default_rng(1)
    tree = {"layer_0": {"attn": {"q_proj": {"kernel": rng.standard_normal((64, 16)),
                                            "lora_a": rng.standard_normal((64, 2))}},
                        "mlp": {"up_proj": {"kernel": np.zeros((64, 8))}}},
            "lm_head": {"kernel": rng.standard_normal((64, 10))},
            "final_norm": {"scale": np.ones(64)}}
    tree = {k: {a: ({b: {c: d.astype(np.float32) for c, d in w.items()} for b, w in v.items()}
                    if isinstance(v, dict) else v.astype(np.float32)) for a, v in t.items()}
            for k, t in tree.items()}
    ours, theirs = tcw.quantize_llama_int4(tree, 32), jcw.quantize_llama_int4(tree, 32)

    def flat(t, p=()):
        for k, v in t.items():
            yield from flat(v, p + (k,)) if isinstance(v, dict) else [(p + (k,), v)]

    a, b = dict(flat(ours)), dict(flat(theirs))
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
    assert ("lm_head", "kernel") in a and ("layer_0", "attn", "q_proj", "w_int4") in a
    with pytest.raises(ValueError, match="must divide"):
        tcw.quantize_llama_int4(tree, 48)


def _linear(quant: str, dtype: str, in_features: int = 64, features: int = 48, **cfg):
    """The port's projection with seeded weights and the JAX params of it."""
    kw = dict(BASE, quantization=quant, dtype=dtype, **cfg)
    tl = init_random_(LlamaLinear(in_features, features, LlamaConfig(**kw)), seed=3)
    jl = JLinear(features, JLlamaConfig(**kw))
    return tl, jl, {"params": {k: v.numpy() for k, v in flax_params(tl).items()}}


@pytest.mark.parametrize("tokens", [4, 20])
def test_int4_linear_matches_jax(tokens):
    """At 4 tokens the per-group partial sums, at 20 the folded-scale
    planes; f32 within 1e-5 relative (the group-sum order)."""
    tl, jl, params = _linear("int4", "float32")
    x = np.random.default_rng(tokens).standard_normal((1, tokens, 64)).astype(np.float32)
    theirs = np.asarray(jl.apply(params, jnp.asarray(x)))
    ours = tl(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-5 * np.abs(theirs).max())


@pytest.mark.parametrize("tokens", [3, 40])
def test_int8_dot_matches_jax_bit_for_bit(tokens):
    """W8A8 in bf16: per-row int8 activations, an exact int32 product and
    the same f32 rescale, so the bf16 results are equal bit for bit."""
    tl, jl, params = _linear("int8", "bfloat16", int8_dot=True, decode_gemv="pallas")
    x = np.random.default_rng(tokens).standard_normal((1, tokens, 64)).astype(np.float32)
    x[0, 1] = 0.0                                   # an all-zero row: x_scale 1
    xb = torch.from_numpy(x).to(torch.bfloat16)
    theirs = np.asarray(jl.apply(params, jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32))
    ours = tl(xb).float().numpy()
    np.testing.assert_array_equal(ours, theirs)
    # and each row alone gives its bits in the batch
    alone = torch.cat([tl(xb[:, i:i + 1]) for i in range(tokens)], dim=1)
    assert torch.equal(alone, tl(xb))


def test_chunked_attention_kv_packed():
    """The packed cache read tile by tile gives the bits of the same
    cache unpacked up front, and JAX's merged-layout result in f32."""
    rng = np.random.default_rng(4)
    b, s, kv, h, d = 2, 5, 40, 2, 8
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k, ks = quantize_kv4(torch.from_numpy(rng.standard_normal((b, kv, h, d)).astype(np.float32)))
    v, vs = quantize_kv4(torch.from_numpy(rng.standard_normal((b, kv, h, d)).astype(np.float32)))
    ks, vs = ks.transpose(1, 2).contiguous(), vs.transpose(1, 2).contiguous()   # (B, H, KV)
    mask = np.ones((b, kv), np.int32)
    mask[1, 30:] = 0
    kw = dict(causal=True, block_k=16, block_q=4, kv_bshd=True, q_bshd=True, q_offset=kv - s,
              scales_bhs=True)
    packed = chunked_attention(torch.from_numpy(q), k, v, torch.from_numpy(mask),
                               k_scale=ks, v_scale=vs, kv_packed=True, **kw)
    unpacked = chunked_attention(torch.from_numpy(q), unpack_int4(k), unpack_int4(v),
                                 torch.from_numpy(mask), k_scale=ks, v_scale=vs, **kw)
    assert torch.equal(packed, unpacked)
    theirs = j_chunked(jnp.asarray(q), jnp.asarray(k.numpy().reshape(b, kv, h * d // 2)),
                       jnp.asarray(v.numpy().reshape(b, kv, h * d // 2)), jnp.asarray(mask),
                       k_scale=jnp.asarray(ks.numpy()), v_scale=jnp.asarray(vs.numpy()),
                       kv_packed=True, unroll_q=True, **kw)
    np.testing.assert_allclose(packed.numpy(), np.asarray(theirs), rtol=1e-5, atol=1e-5)


def _decoders(fmt: str, **extra):
    kw = dict(BASE, **FORMATS[fmt], **extra)
    tm = init_random_(LlamaModel(LlamaConfig(**kw)), seed=5)
    return tm, JLlama(JLlamaConfig(**kw), None), {"params": jax_tree(tm)}


def _prefix(b=3, s=12):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((b, s, 64)).astype(np.float32)
    mask = np.ones((b, s), np.int32)
    mask[0, :3] = 0
    mask[2, 5:7] = 0
    return x, mask


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_greedy_matches_jax(fmt):
    tm, jm, params = _decoders(fmt)
    x, mask = _prefix()
    theirs = np.asarray(j_greedy(jm, params, jnp.asarray(x), jnp.asarray(mask), 8, 259))
    ours = greedy_generate(tm, torch.from_numpy(x), torch.from_numpy(mask), 8, 259).numpy()
    np.testing.assert_array_equal(ours, theirs)
    if FORMATS[fmt]["kv_quant"] == "int4":
        cache = init_cache(tm.cfg, 1, 4, "cpu")
        assert cache[0]["k"].dtype == torch.uint8 and cache[0]["k"].shape == (1, 4, 4, 8)


def test_engine_int4_kv_keep_matches_offline():
    """The serving engine over an int4 cache under SnapKV ``kv_keep``:
    each request's tokens are the offline decoder's (the same
    compaction, batch 5)."""
    keep = dict(kv_keep=8, kv_keep_obs=4, kv_keep_sink=2)
    tm, _, _ = _decoders("int4_both", **keep)
    prefixes = _prefixes(5, seed=1)
    x = torch.from_numpy(np.stack([e for e, _ in prefixes]))
    m = torch.from_numpy(np.stack([k for _, k in prefixes]))
    ref = greedy_generate(tm, x, m, NEW, 259).numpy()
    eos = int(ref[1, 2])
    ref = greedy_generate(tm, x, m, NEW, eos).numpy()
    reqs = [Request(i, e, k) for i, (e, k) in enumerate(prefixes)]
    got = _drive(ContinuousBatcher(tm, S, NEW, eos, max_slots=2), reqs)
    _check_greedy(got, ref, eos, range(5))
    assert any(len(t) < NEW for t in got.values())       # a slot freed early and refilled


def _backbone(backbone: str, fmt: str):
    """(JAX model, JAX params, port model) of a backbone at tiny width in
    f32, its LLM in the format ``fmt``, from the port's seeded weights."""
    from mraudio_tpu import config as jconfig
    from mraudio_tpu.models import videollama as jvl
    from mraudio_tpu.models.xinstructblip import XInstructBLIP as JModel
    from mraudio_tpu_torch import config as tconfig
    from mraudio_tpu_torch.models import videollama as tvl
    from mraudio_tpu_torch.models.xinstructblip import XInstructBLIP
    from test_torch_train_loss import f32_cfg

    audio = dict(num_mel_bins=16, mel_frames_per_chunk=32)
    llm = dict(FORMATS[fmt], int4_group_size=32)
    if backbone == "videollama":
        from test_torch_videollama import _flavour

        tcfg, jcfg = _flavour(tvl, "clip"), _flavour(jvl, "clip")
        tcfg, jcfg = (c.replace(llm=c.llm.replace(**llm)) for c in (tcfg, jcfg))
        tm = tvl.VideoLLaMA(tcfg, audio_cfg=tconfig.AudioFrontendConfig(**audio), device="cpu")
        jm = jvl.VideoLLaMA(jcfg, audio_cfg=jconfig.AudioFrontendConfig(**audio))
    else:
        tcfg, jcfg = f32_cfg(tconfig.tiny_model_config()), f32_cfg(jconfig.tiny_model_config())
        tcfg, jcfg = (c.replace(llm=c.llm.replace(**llm)) for c in (tcfg, jcfg))
        tm = XInstructBLIP(tcfg, audio_cfg=tconfig.AudioFrontendConfig(**audio), device="cpu")
        jm = JModel(jcfg, audio_cfg=jconfig.AudioFrontendConfig(**audio))
    init_random_(tm, seed=7)
    return jm, jax.tree_util.tree_map(jnp.asarray, jax_tree(tm)), tm


@pytest.mark.parametrize("backbone", ["xinstructblip", "videollama"])
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_backbone_generate_matches_jax(backbone, fmt):
    """Both backbones' ``generate`` in each int4 format: token ids and
    strings identical to JAX's."""
    from test_torch_train_loss import train_batch

    jm, params, tm = _backbone(backbone, fmt)
    batch = train_batch(b=2, t=4)
    theirs = np.asarray(jm.generate_submit(params, batch)[0] if backbone == "xinstructblip"
                        else jm.generate_submit(params, batch))
    ours = tm.generate_submit(batch=batch)
    ours = (ours[0] if backbone == "xinstructblip" else ours).numpy()
    np.testing.assert_array_equal(ours, theirs)


def test_int4_linear_lora_gradient_matches_jax():
    """Training over int4 base weights (the JAX ``LlamaLinear`` allows
    them): the LoRA leaves' gradients of a projection's output through
    the frozen int4 planes, against ``jax.grad``, within 1e-5 of the
    largest |g| (the group-sum order)."""
    from mraudio_tpu.config import LoraConfig as JLoraConfig
    from mraudio_tpu_torch.config import LoraConfig

    kw = dict(BASE, quantization="int4", dtype="float32")
    tl = init_random_(LlamaLinear(64, 48, LlamaConfig(**kw), lora=LoraConfig(rank=2, alpha=2),
                                  lora_target=True), seed=8)
    with torch.no_grad():
        tl.lora_b.copy_(torch.randn(tl.lora_b.shape, generator=torch.Generator().manual_seed(9)))
    jl = JLinear(48, JLlamaConfig(**kw), lora=JLoraConfig(rank=2, alpha=2), lora_target=True)
    params = {k: jnp.asarray(v.numpy()) for k, v in flax_params(tl).items()}
    x = np.random.default_rng(10).standard_normal((1, 20, 64)).astype(np.float32)

    def loss(lora):
        y = jl.apply({"params": {**params, **lora}}, jnp.asarray(x))
        return jnp.sum(jnp.square(y))

    theirs = jax.grad(loss)({k: params[k] for k in ("lora_a", "lora_b")})
    leaves = [tl.lora_a, tl.lora_b]
    for p in leaves:
        p.requires_grad_(True)
    ours = torch.autograd.grad(tl(torch.from_numpy(x)).square().sum(), leaves)
    for name, g in zip(("lora_a", "lora_b"), ours):
        want = np.asarray(theirs[name])
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
