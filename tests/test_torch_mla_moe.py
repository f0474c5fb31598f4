"""The port's DeepSeek-V3 decoder (latent attention, ``models/mla.py``; the
expert layer, ``models/moe.py``) against the plain float32 reference
``plain_deepseek_v3.py``, and that reference against ``transformers``'
``DeepseekV3ForCausalLM``, at tiny sizes on the CPU in float32.

Tolerances: the port and the references all compute in float32 here; they
differ only in the order of their sums (online softmax over key chunks
against one softmax, the latent-absorbed decode products against the
decompressed ones, grouped products against a loop over experts), which
moves float32 results by about 1e-6 relative per layer.  So the logits
agree to 1e-4 relative (norm of the difference over the reference's),
well under the 1e-2 to 1 that any planted change of the mathematics gives
at these sizes.  The seeds give no near-tie in the routing, where the
order of sums could flip an expert."""

import hashlib
import json
from types import SimpleNamespace

import pytest
import torch

import plain_deepseek_v3 as ref
from mraudio_tpu_torch.config import LlamaConfig, LoraConfig
from mraudio_tpu_torch.infer.generate import greedy_generate
from mraudio_tpu_torch.models.llama import LlamaModel, init_cache, refuse_unsupported
from mraudio_tpu_torch.models.moe import ExpertCounters, MoeMlp
from mraudio_tpu_torch.ops.attention import chunked_attention

torch.set_num_threads(1)

TOL = 1e-4
TINY = dict(vocab_size=96, hidden_size=64, num_layers=3, num_heads=4, num_kv_heads=4,
            intermediate_size=96, rope_theta=800000.0, rms_norm_eps=1e-5, max_seq_len=512,
            dtype="float32", attention_kind="mla", kv_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16, rope_interleave=True, n_routed_experts=8,
            num_experts_per_tok=3, n_shared_experts=2, moe_intermediate_size=32,
            first_k_dense_replace=1, routed_scaling_factor=2.446, norm_topk_prob=True,
            attention_impl="chunked", decode_gemv="pallas", prefill_chunk=0)
# Kimi-VL-A3B-Instruct's text config (its config.json), in LlamaConfig's names
KIMI = dict(vocab_size=163840, hidden_size=2048, num_layers=27, num_heads=16, num_kv_heads=16,
            intermediate_size=11264, rope_theta=800000.0, rms_norm_eps=1e-5,
            attention_kind="mla", kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
            v_head_dim=128, rope_interleave=True, n_routed_experts=64, num_experts_per_tok=6,
            n_shared_experts=2, moe_intermediate_size=1408, first_k_dense_replace=1,
            routed_scaling_factor=2.446, norm_topk_prob=True, attention_impl="chunked")


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def _seeded(model, seed: int = 0) -> dict:
    """Fill ``model``'s parameters with seeded values sized so that every
    layer's output is of order one: kernels N(0, 1 / fan_in), norm scales
    1 + N(0, 0.1), the router's bias N(0, 0.05).  Returns the weights."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            z = torch.randn(p.shape, generator=gen)
            if name.endswith("scale"):
                p.copy_(1 + 0.1 * z)
            elif name.endswith("router.bias"):
                p.copy_(0.05 * z)
            elif name.endswith("embedding"):
                p.copy_(z)
            else:
                p.copy_(z / p.shape[0] ** 0.5)
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _model(**changes):
    model = LlamaModel(LlamaConfig(**dict(TINY, **changes)))
    return model, _seeded(model)


def test_prefill_logits_match_the_reference():
    model, w = _model()
    x = torch.randn(2, 37, 64, generator=torch.Generator().manual_seed(1))
    mask = torch.ones(2, 37, dtype=torch.int32)
    with torch.no_grad():
        got, _ = model(x, None, torch.arange(37)[None].expand(2, -1), kv_valid=mask,
                       causal=True)
        for b in range(2):
            want = ref.decoder_logits(w, x[b], TINY)
            assert _rel(got[b], want) < TOL


def test_prefill_and_decode_through_the_latent_cache_match_the_reference():
    """Left-padded rows of different lengths in one batch: the prefill, then
    8 greedy decode passes over the latent cache, each pass's logits
    against the reference's full forward over the row's unpadded
    sequence."""
    model, w = _model()
    lengths, s, new = [30, 22, 13], 30, 8
    x = torch.randn(3, s, 64, generator=torch.Generator().manual_seed(2))
    mask = torch.zeros(3, s, dtype=torch.int32)
    for b, n in enumerate(lengths):
        mask[b, s - n:] = 1
    kept = []
    hook = model.lm_head.register_forward_hook(lambda m, a, out: kept.append(out[:, -1].clone()))
    stats = {}
    tokens = greedy_generate(model, x, mask, new, eos_id=10 ** 6, stats=stats)
    hook.remove()
    assert stats["decode_steps"] == new and len(kept) == new + 1
    cache = init_cache(model.cfg, 1, 4, "cpu")
    assert set(cache[0]) == {"latent"} and cache[0]["latent"].shape == (1, 4, 32 + 8)
    with torch.no_grad():
        for b, n in enumerate(lengths):
            seq = torch.cat([x[b, s - n:], model.embed(tokens[b, :new])])
            want = ref.decoder_logits(w, seq, TINY, at=torch.arange(n - 1, n + new))
            got = torch.stack([k[b] for k in kept])[:, :TINY["vocab_size"]]
            assert _rel(got, want) < TOL, b


def test_the_replayed_decode_loop_gives_the_eager_loops_tokens(monkeypatch):
    """The route a card takes for this decoder (``infer/generate.py``: the
    first pass eager on tensors updated in place, the cache column a (B,)
    tensor, then replays of a captured pass), with each replay here a
    Python rerun of the captured step: the tokens, passes and routing
    counters of the eager loop, with left-padded rows."""
    import mraudio_tpu_torch.infer.generate as generate

    class Rerun:
        def __init__(self, step, model, dev):
            self.step = step

        def replay(self):
            self.step()

    model, _ = _model()
    assert model.decode_graph
    lengths, s, new = [30, 22, 13], 30, 8
    x = torch.randn(3, s, 64, generator=torch.Generator().manual_seed(2))
    mask = torch.zeros(3, s, dtype=torch.int32)
    for b, n in enumerate(lengths):
        mask[b, s - n:] = 1

    def run(eos_id):
        stats = {}
        return greedy_generate(model, x, mask, new, eos_id=eos_id, stats=stats), stats

    eager, eager_stats = run(10 ** 6)
    eos = int(eager[0, 2])              # so that row 0 ends after 3 tokens
    eager_eos, _ = run(eos)
    monkeypatch.setattr(generate, "_replays_decode", lambda model, dev: True)
    monkeypatch.setattr(generate, "_GraphedPass", Rerun)
    replayed, replay_stats = run(10 ** 6)
    assert torch.equal(eager, replayed)
    for key in ("decode_steps", "moe_decode_experts", "moe_prefill_imbalance"):
        assert replay_stats[key] == eager_stats[key], key
    replayed_eos, _ = run(eos)
    assert torch.equal(eager_eos, replayed_eos) and (replayed_eos[0, 3:] == eos).all()


def test_expert_layer_matches_the_per_expert_loop_with_idle_experts():
    cfg = LlamaConfig(**TINY)
    moe = MoeMlp(cfg)
    w = {"mlp." + k: v for k, v in _seeded(moe, 3).items()}
    moe.counters = ExpertCounters()
    for tokens in (3, 40):
        x = torch.randn(1, tokens, 64, generator=torch.Generator().manual_seed(tokens))
        with torch.no_grad():
            got = moe(x, decode=tokens == 3)[0]
            want = ref.moe(w, "mlp.", x[0], TINY)
            ids, _ = ref.route(w, "mlp.", x[0], TINY)
        assert _rel(got, want) < TOL
        counts = torch.bincount(ids.reshape(-1), minlength=8)
        if tokens == 3:
            assert (counts == 0).any()          # 9 picks cannot reach all 8 experts
            distinct = int((counts > 0).sum())
        else:
            imbalance = float(counts.max() / counts.float().mean())
    read = moe.counters.read()
    assert read["moe_decode_experts"] == pytest.approx(distinct)
    assert read["moe_prefill_imbalance"] == pytest.approx(imbalance)


def test_the_reference_follows_transformers_deepseek_v3():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.DeepseekV3Config(
        vocab_size=96, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4, n_shared_experts=2,
        n_routed_experts=8, routed_scaling_factor=2.446, kv_lora_rank=32, q_lora_rank=None,
        qk_rope_head_dim=8, v_head_dim=16, qk_nope_head_dim=16, n_group=1, topk_group=1,
        num_experts_per_tok=3, first_k_dense_replace=1, norm_topk_prob=True,
        rope_interleave=True, rms_norm_eps=1e-5, rope_theta=800000.0, max_position_embeddings=512,
        attention_bias=False, tie_word_embeddings=False)
    hf_cfg._attn_implementation = "eager"
    torch.manual_seed(4)
    hf = transformers.DeepseekV3ForCausalLM(hf_cfg).float().eval()
    with torch.no_grad():
        for name, p in hf.named_parameters():
            z = torch.randn(p.shape)
            p.copy_(1 + 0.1 * z if name.endswith("norm.weight") else z / p.shape[-1] ** 0.5)
        for layer in hf.model.layers[1:]:
            layer.mlp.gate.e_score_correction_bias.copy_(0.05 * torch.randn(8))
    w = _from_transformers(hf.state_dict(), hf_cfg)
    x = torch.randn(21, 64)
    with torch.no_grad():
        want = hf(inputs_embeds=x[None]).logits[0]
        got = ref.decoder_logits(w, x, TINY)
    assert _rel(got, want) < TOL


def _from_transformers(sd: dict, cfg) -> dict:
    """``DeepseekV3ForCausalLM``'s weights under the port's names and
    layouts."""
    w = {"final_norm.scale": sd["model.norm.weight"], "lm_head.kernel": sd["lm_head.weight"].T}
    width = cfg.moe_intermediate_size
    for i in range(cfg.num_hidden_layers):
        src, dst = f"model.layers.{i}.", f"layers.{i}."
        w[dst + "input_norm.scale"] = sd[src + "input_layernorm.weight"]
        w[dst + "post_attn_norm.scale"] = sd[src + "post_attention_layernorm.weight"]
        w[dst + "attn.kv_a_layernorm.scale"] = sd[src + "self_attn.kv_a_layernorm.weight"]
        for proj in ("q_proj", "kv_a_proj_with_mqa", "kv_b_proj", "o_proj"):
            w[dst + f"attn.{proj}.kernel"] = sd[src + f"self_attn.{proj}.weight"].T
        shared = ["shared_experts."] if i >= cfg.first_k_dense_replace else [""]
        for part in shared:
            for proj in ("gate_proj", "up_proj", "down_proj"):
                w[dst + f"mlp.{part}{proj}.kernel"] = sd[src + f"mlp.{part}{proj}.weight"].T
        if i >= cfg.first_k_dense_replace:
            w[dst + "mlp.router.kernel"] = sd[src + "mlp.gate.weight"].T
            w[dst + "mlp.router.bias"] = sd[src + "mlp.gate.e_score_correction_bias"]
            e = cfg.n_routed_experts
            gate_up = torch.empty(cfg.hidden_size, e, 2 * width)
            down = torch.empty(width, e, cfg.hidden_size)
            for j in range(e):
                gate_up[:, j, :width] = sd[src + f"mlp.experts.{j}.gate_proj.weight"].T
                gate_up[:, j, width:] = sd[src + f"mlp.experts.{j}.up_proj.weight"].T
                down[:, j] = sd[src + f"mlp.experts.{j}.down_proj.weight"].T
            w[dst + "mlp.experts.gate_up.kernel"] = gate_up
            w[dst + "mlp.experts.down.kernel"] = down
    return w


def _tree_hash(model) -> str:
    tree = [(n, type(m).__name__, list(getattr(m, "dropout_id", ())))
            for n, m in model.named_modules()]
    sd = [(n, list(t.shape), str(t.dtype)) for n, t in model.state_dict().items()]
    return hashlib.sha256(json.dumps([tree, sd]).encode()).hexdigest()


# the module trees, dropout ids and state-dict keys of two dense decoders
# before latent attention and experts came (hashes of _tree_hash's list)
DENSE = {
    "qwen2": ("c9c85c9d7fc2f66b5c1850d8416217fa302d311ed2231c21695d37751574003c",
              "1b2528922338cdd2ae31e635795a4f3af1ed5bead40fbc2c36aaf091604ca9c8"),
    "llama": ("ddb893b8220af1b5456c6e8ec99e7b1dddc8cad5222d34cf1114c14116963dc0",
              "03ef6bbf7d0a590bda233e2acf541ea5100b5d7889ed44c43e3f5efc213c8784"),
}


@pytest.mark.parametrize("name", sorted(DENSE))
def test_dense_decoders_build_what_they_built(name):
    common = dict(vocab_size=260, hidden_size=64, num_layers=2, num_heads=4,
                  intermediate_size=128, dtype="float32")
    cfg = (LlamaConfig(num_kv_heads=2, attention_bias=True, rope_theta=1e6, **common)
           if name == "qwen2" else LlamaConfig(num_kv_heads=4, **common))
    plain, lora = DENSE[name]
    assert _tree_hash(LlamaModel(cfg)) == plain
    assert _tree_hash(LlamaModel(cfg, LoraConfig(rank=2, alpha=2))) == lora
    assert LlamaModel(cfg).expert_counters is None


@pytest.mark.parametrize("field,value", [
    ("kv_quant", "int8"), ("kv_keep", 64), ("attention_impl", "pallas"), ("mlp_seq_chunk", 16),
    ("quantization", "int4"), ("quantization", "int8"), ("seq_shard", True),
    ("scan_layers", True)])
def test_each_unsupported_setting_is_refused(field, value):
    with pytest.raises(NotImplementedError, match=field):
        LlamaModel(LlamaConfig(**dict(TINY, **{field: value})))


def test_lora_and_bad_shapes_are_refused():
    with pytest.raises(NotImplementedError, match="lora.enabled"):
        refuse_unsupported(LlamaConfig(**TINY), LoraConfig())
    with pytest.raises(NotImplementedError, match="rope_interleave"):
        refuse_unsupported(LlamaConfig(rope_interleave=True))
    with pytest.raises(ValueError, match="attention_kind"):
        refuse_unsupported(LlamaConfig(attention_kind="linear"))
    with pytest.raises(ValueError, match="num_experts_per_tok"):
        refuse_unsupported(LlamaConfig(**dict(TINY, num_experts_per_tok=9)))


def test_the_serving_engine_refuses_the_decoder():
    from mraudio_tpu_torch.infer.serving import ContinuousBatcher

    with pytest.raises(NotImplementedError, match="serving engine"):
        ContinuousBatcher(LlamaModel(LlamaConfig(**TINY)), prefix_len=8, max_new_tokens=4,
                          eos_id=2)


def test_a_model_axis_is_refused():
    from mraudio_tpu_torch.parallel.partition import shard_module_

    with pytest.raises(NotImplementedError, match="mesh.model"):
        shard_module_(LlamaModel(LlamaConfig(**TINY)), SimpleNamespace(model=2))


def test_kimi_vl_decoder_builds_at_its_published_size():
    """On the meta device: 27 layers (1 dense, 26 of experts), 64 experts of
    width 1408 with 2 shared, MLA at 512 / 128 / 64 / 128, vocab 163840:
    15.96 B parameters, 14.85 B of them in the 26 expert layers (14.39 B in
    the routed experts, stacked in the serving dtype), 0.37 B in the
    attention, 0.67 B in the embedding and the lm_head."""
    with torch.device("meta"):
        model = LlamaModel(LlamaConfig(**KIMI))
    params = dict(model.named_parameters())

    def billions(pred):
        return round(sum(p.numel() for n, p in params.items() if pred(n)) / 1e9, 2)

    assert billions(lambda n: True) == 15.96
    assert billions(lambda n: ".mlp." in n and not n.startswith("layers.0.")) == 14.85
    assert billions(lambda n: ".experts." in n) == 14.39
    assert billions(lambda n: ".attn." in n) == 0.37
    assert billions(lambda n: n.startswith(("embed_tokens", "lm_head"))) == 0.67
    assert params["layers.1.mlp.experts.gate_up.kernel"].shape == (2048, 64, 2816)
    assert params["layers.1.mlp.experts.gate_up.kernel"].dtype == torch.bfloat16
    assert not hasattr(model.layers[0].mlp, "router") and model.layers[26].moe
    with torch.device("meta"):
        cache = init_cache(model.cfg, 4, 11187, "meta")
    assert len(cache) == 27 and cache[0]["latent"].shape == (4, 11187, 576)


def test_chunked_attention_takes_values_narrower_than_queries():
    gen = torch.Generator().manual_seed(5)
    q, k = torch.randn(2, 3, 40, 24, generator=gen), torch.randn(2, 3, 40, 24, generator=gen)
    v = torch.randn(2, 3, 40, 8, generator=gen)
    mask = torch.ones(2, 40, dtype=torch.int32)
    mask[1, :7] = 0
    out = chunked_attention(q, k, v, mask, causal=True, block_k=16, block_q=16)
    logits = (q @ k.transpose(-1, -2)) * 24 ** -0.5
    ok = torch.ones(40, 40, dtype=torch.bool).tril()[None, None] & (mask[:, None, None] > 0)
    want = torch.where(ok, logits, float("-inf")).softmax(-1).nan_to_num() @ v
    assert out.shape == (2, 3, 40, 8) and _rel(out[:, :, 7:], want[:, :, 7:]) < 1e-5
