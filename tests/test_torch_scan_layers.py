"""``scan_layers`` and ``mlp_seq_chunk`` in the port against the JAX
package.

``scan_layers`` is a parameter layout in the port: the modules and the
cache stay per layer, and the flat names at every boundary become the
JAX package's stacked ``layers`` leaves.  A stacked tree from the port's
seeded weights loads and gives the JAX scan model's logits within JAX's
own 2e-5 (``tests/test_scan_layers.py``); the port's two layouts give the
same bits (logits, greedy tokens over an int4 cache), and the param
store and the trainer's checkpoints carry the stacked names, LoRA leaves
included.  ``mlp_seq_chunk`` tiles the MLP's token axis: bit-exact
against the port's unchunked MLP, and within JAX's 2e-5 of JAX's chunked
MLP."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mraudio_tpu.config import LlamaConfig as JLlamaConfig
from mraudio_tpu.config import LoraConfig as JLoraConfig
from mraudio_tpu.models.llama import LlamaMlp as JMlp
from mraudio_tpu.models.llama import LlamaModel as JLlama
from mraudio_tpu_torch.config import LlamaConfig, LoraConfig
from mraudio_tpu_torch.infer.generate import greedy_generate
from mraudio_tpu_torch.models.convert_jax import (flax_params, init_random_, load_jax_params_,
                                                  nested, stack_layers, unstack_layers)
from mraudio_tpu_torch.models.layers import positions_from_mask
from mraudio_tpu_torch.models.llama import LlamaMlp, LlamaModel

torch.set_num_threads(1)

TINY = dict(vocab_size=64, hidden_size=32, num_layers=3, num_heads=4, num_kv_heads=4,
            intermediate_size=64, max_seq_len=64, dtype="float32")


def _tree(flat: dict) -> dict:
    return nested({k: t.numpy().copy() for k, t in flat.items()})


def _seeded(cfg, seed=0):
    """A per-layer port decoder with seeded weights and a non-zero LoRA B."""
    model = init_random_(LlamaModel(LlamaConfig(**cfg), LoraConfig(rank=2, alpha=2)), seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_b"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    return model


def _inputs(b=2, s=6):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((b, s, 32)) * 0.3).astype(np.float32)
    mask = np.ones((b, s), np.int32)
    mask[1, :2] = 0
    attend = np.tril(np.ones((s, s), bool))[None, None] & mask[:, None, None, :].astype(bool)
    pos = positions_from_mask(torch.from_numpy(mask)).numpy()
    return x, mask, attend, pos


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_stacked_tree_loads_and_matches_jax_scan(quant):
    loop = _seeded(dict(TINY, quantization=quant))
    stacked = flax_params(loop, stacked=True)
    assert stacked["layers/attn/q_proj/lora_a"].shape == (3, 32, 2)
    scan = load_jax_params_(LlamaModel(LlamaConfig(**TINY, quantization=quant, scan_layers=True),
                                       LoraConfig(rank=2, alpha=2)), _tree(stacked))
    x, mask, attend, pos = _inputs()
    jm = JLlama(JLlamaConfig(**TINY, quantization=quant, scan_layers=True),
                JLoraConfig(rank=2, alpha=2))
    theirs, _ = jm.apply({"params": _tree(stacked)}, jnp.asarray(x), jnp.asarray(attend),
                         jnp.asarray(pos), kv_valid=jnp.asarray(mask), causal=True)
    args = (torch.from_numpy(x), torch.from_numpy(attend), torch.from_numpy(pos))
    ours, _ = scan(*args, kv_valid=torch.from_numpy(mask), causal=True)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), rtol=2e-5, atol=2e-5)
    # the two port layouts: the same modules, the same bits
    again, _ = loop(*args, kv_valid=torch.from_numpy(mask), causal=True)
    assert torch.equal(ours, again)
    assert sorted(flax_params(scan)) == sorted(stacked)


def test_layouts_agree_on_greedy_over_int4_cache():
    cfg = dict(TINY, quantization="int4", int4_group_size=16, kv_quant="int4", prefill_chunk=4)
    loop = _seeded(cfg, seed=2)
    scan = load_jax_params_(LlamaModel(LlamaConfig(**cfg, scan_layers=True),
                                       LoraConfig(rank=2, alpha=2)),
                            _tree(flax_params(loop, stacked=True)))
    x, mask, _, _ = _inputs(b=3, s=10)
    args = (torch.from_numpy(x), torch.from_numpy(mask), 8, 63)
    assert torch.equal(greedy_generate(scan, *args), greedy_generate(loop, *args))


def test_stack_and_unstack_layers():
    flat = flax_params(_seeded(TINY), stacked=False)
    flat = {f"llm/{k}": v for k, v in flat.items()}
    stacked = stack_layers(flat, "llm", 3)
    assert "llm/layers/mlp/down_proj/kernel" in stacked and "llm/final_norm/scale" in stacked
    assert not any("layer_" in k for k in stacked)
    back = unstack_layers(stacked)
    assert sorted(back) == sorted(flat)
    assert all(torch.equal(back[k], flat[k]) for k in flat)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_seq_chunk(dtype):
    """Tiles of 16 tokens (the last one padded) give the unchunked MLP's
    bits, and JAX's chunked MLP's output within 2e-5 in f32."""
    cfg = dict(TINY, dtype=dtype, quantization="int8")
    plain = init_random_(LlamaMlp(LlamaConfig(**cfg), LoraConfig(rank=2, alpha=2)), seed=4)
    chunked = LlamaMlp(LlamaConfig(**cfg, mlp_seq_chunk=16), LoraConfig(rank=2, alpha=2))
    chunked.load_state_dict(plain.state_dict())
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 40, 32)).astype(np.float32))
    x = x.to(getattr(torch, dtype))
    with torch.no_grad():
        ours = chunked(x)
        assert torch.equal(ours, plain(x))
    if dtype == "float32":
        jm = JMlp(JLlamaConfig(**cfg, mlp_seq_chunk=16), JLoraConfig(rank=2, alpha=2))
        params = {"params": _tree(flax_params(plain))}
        theirs = jm.apply(params, jnp.asarray(x.numpy()))
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=2e-5, atol=2e-5)
    # under autograd each tile is recomputed in the backward
    lora = [p for n, p in chunked.named_parameters() if "lora" in n]
    for p in lora:
        p.requires_grad_(True)
    chunked(x).float().square().sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in lora)


def test_stacked_checkpoint_and_store(tmp_path):
    """A checkpoint in the JAX layout, its LoRA leaves stacked, loads into
    either layout's modules (``apply_trainable``); the param store of a
    ``scan_layers`` model holds the stacked names and loads back."""
    from mraudio_tpu_torch.cli.convert import load_param_store, save_param_store
    from mraudio_tpu_torch.train.checkpoint import (apply_trainable, load_checkpoint,
                                                    save_checkpoint)

    rng = np.random.default_rng(6)
    leaf = torch.from_numpy(rng.standard_normal((3, 32, 2)).astype(np.float32))
    path = save_checkpoint(str(tmp_path), "best", {"layers/mlp/up_proj/lora_a": leaf}, {}, 0)
    for scan in (False, True):
        model = _seeded(dict(TINY, scan_layers=scan))
        apply_trainable(model, load_checkpoint(path)["model"])
        for i, block in enumerate(model.layers):
            assert torch.equal(block.mlp.up_proj.lora_a, leaf[i])
    scan_model = _seeded(dict(TINY, scan_layers=True), seed=8)
    store = save_param_store(str(tmp_path / "s.pt"), scan_model, {"scan_layers": True})
    flat = torch.load(store, weights_only=True)
    assert flat["layers/attn/q_proj/kernel"].shape == (3, 32, 32)
    loaded = load_jax_params_(LlamaModel(LlamaConfig(**TINY), LoraConfig(rank=2, alpha=2)),
                              load_param_store(store))
    assert all(torch.equal(a, b) for a, b in zip(loaded.parameters(), scan_model.parameters()))
