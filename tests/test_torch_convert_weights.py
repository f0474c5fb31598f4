"""The port's checkpoint converters against the JAX package's, on
fabricated tiny checkpoints in the real key layouts.

Bit for bit, no tolerance: the fabricators give JAX's arrays for the same
seed; every converter (EVA, both Q-Former bundles, the BLIP-2 fallback,
BEATs, HF Llama with its vocab pad, tied head and bias-flavour errors)
and ``quantize_llama_int8`` give JAX's tree, leaf for leaf, with the same
keys and dtypes; ``load_pretrained_params`` puts into the port's modules
what JAX's overlay puts into its tree, in the checkpoints' dtypes (f32,
and fp16 for a Vicuna state dict cast in the test) before and after the
inference cast, and leaves the same leaves uncovered: the LoRA A and B
matrices.  Both random inits are replaced by one sentinel fill (NaN,
int8 -128), so that an uncovered leaf shows and the ~30 s flax init is
not run.  Last, the LoRA delta with a non-zero B (ROADMAP C.1) gives
JAX's logits."""

import contextlib

import numpy as np
import pytest

import jax
import torch

import mraudio_tpu.models.convert_weights as jcw
import mraudio_tpu.models.fabricate as jfab
from mraudio_tpu.config import LlamaConfig as JLlamaConfig
from mraudio_tpu.config import LoraConfig as JLoraConfig
from mraudio_tpu.config import RunConfig as JRunConfig
from mraudio_tpu.config import tiny_data_config as j_tiny_data
from mraudio_tpu.config import tiny_model_config as j_tiny
from mraudio_tpu.models.casting import cast_params_for_inference as j_cast
from mraudio_tpu.models.llama import LlamaModel as JLlama
from mraudio_tpu.models.xinstructblip import XInstructBLIP as JModel
import mraudio_tpu_torch.models.convert_weights as tcw
import mraudio_tpu_torch.models.fabricate as tfab
from mraudio_tpu_torch.config import LlamaConfig, LoraConfig, RunConfig
from mraudio_tpu_torch.config import tiny_data_config, tiny_model_config
from mraudio_tpu_torch.models.casting import cast_params_for_inference
from mraudio_tpu_torch.models.convert_jax import flax_params, load_jax_params_
from mraudio_tpu_torch.models.factory import build_model
from mraudio_tpu_torch.models.llama import LlamaModel

torch.set_num_threads(1)

ROLES = tuple(tcw.WEIGHT_FIELDS)
WEIGHT_FIELDS = tcw.WEIGHT_FIELDS


# --------------------------------------------------------------------------
# helpers shared with test_torch_param_store.py and test_torch_parity_cli.py
# --------------------------------------------------------------------------


def flat(tree, prefix=()):
    """``{'/'-joined path: leaf}`` of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (str(k),)))
        else:
            out["/".join(prefix + (str(k),))] = v
    return out


def as_numpy(x):
    """A leaf of either package as (numpy array, dtype name); bf16 as its
    exact f32 values."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        name = str(x.dtype).removeprefix("torch.")
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy(), name
    x = np.asarray(x)
    return (x.astype(np.float32) if x.dtype.name == "bfloat16" else x), x.dtype.name


def assert_same_leaves(ours: dict, theirs: dict, skip=()):
    """Same flat keys; each leaf the same shape, dtype and values, signs
    of zeros included (a NaN equals a NaN), unless its key contains one
    of ``skip``."""
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        if any(s in k for s in skip):
            continue
        (a, da), (b, db) = as_numpy(ours[k]), as_numpy(theirs[k])
        assert a.shape == b.shape and da == db, (k, a.shape, da, b.shape, db)
        floating = a.dtype.kind == "f"
        assert np.array_equal(a, b, equal_nan=floating), k
        if floating:
            assert np.array_equal(np.signbit(a), np.signbit(b)) or np.isnan(a).any(), k


def _fill(tree, float_value):
    return {k: _fill(v, float_value) if isinstance(v, dict)
            else np.full(v.shape, -128 if v.dtype == np.int8 else float_value, v.dtype)
            for k, v in tree.items()}


@contextlib.contextmanager
def jax_init_filled(float_value=np.nan):
    """JAX's ``XInstructBLIP.init_params`` replaced by a fill of its
    shapes (``jax.eval_shape``): ``float_value`` for float leaves, -128
    for int8 ones."""
    real = JModel.init_params

    def filled(self, rng, jit=None):
        return _fill(jax.eval_shape(lambda: real(self, rng, jit=False)), float_value)

    JModel.init_params = filled
    try:
        yield
    finally:
        JModel.init_params = real


@torch.no_grad()
def _sentinel_(module, seed=0):
    for p in module.parameters():
        p.fill_(-128 if p.dtype == torch.int8 else float("nan"))
    return module


def configs(quantization="int8", dtype="float32", **paths):
    """(JAX, port) tiny RunConfigs in ``dtype`` with ``paths`` as weight
    fields."""
    out = []
    for run_cfg, tiny, data in ((JRunConfig, j_tiny, j_tiny_data),
                                (RunConfig, tiny_model_config, tiny_data_config)):
        m = tiny(quantization=quantization)
        m = m.replace(llm=m.llm.replace(dtype=dtype), vit=m.vit.replace(dtype=dtype),
                      beats=m.beats.replace(dtype=dtype), qformer=m.qformer.replace(dtype=dtype))
        out.append(run_cfg(model=m, data=data(n_frms=4), **paths))
    return out


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The port's fabricated tiny checkpoints: {role: path}."""
    return tfab.fabricate_checkpoint_dir(tiny_model_config(), str(tmp_path_factory.mktemp("ck")))


# --------------------------------------------------------------------------
# fabricators
# --------------------------------------------------------------------------


def test_fabricators_give_jax_arrays(tmp_path):
    jm, tm = j_tiny(), tiny_model_config()
    pairs = [
        (jfab.fabricate_eva_sd(jm.vit), tfab.fabricate_eva_sd(tm.vit)),
        (jfab.fabricate_beats_ckpt(jm.beats)["model"], tfab.fabricate_beats_ckpt(tm.beats)["model"]),
        (jfab.fabricate_qformer_bundle_ckpt(jm, "video")["model"],
         tfab.fabricate_qformer_bundle_ckpt(tm, "video")["model"]),
        (jfab.fabricate_qformer_bundle_ckpt(jm, "audio")["model"],
         tfab.fabricate_qformer_bundle_ckpt(tm, "audio")["model"]),
        (jfab.fabricate_blip2_ckpt(jm)["model"], tfab.fabricate_blip2_ckpt(tm)["model"]),
        (jfab.fabricate_llama_hf_sd(jm.llm), tfab.fabricate_llama_hf_sd(tm.llm)),
        (jfab.fabricate_llama_hf_sd(jm.llm.replace(attention_bias=True), vocab=300),
         tfab.fabricate_llama_hf_sd(tm.llm.replace(attention_bias=True), vocab=300)),
    ]
    for theirs, ours in pairs:
        assert_same_leaves(ours, theirs)
    # the directory: the same files, read by either package's loader
    jpaths = jfab.fabricate_checkpoint_dir(jm, str(tmp_path / "jax"), seed=3)
    tpaths = tfab.fabricate_checkpoint_dir(tm, str(tmp_path / "port"), seed=3)
    assert sorted(jpaths) == sorted(tpaths) == sorted(ROLES)
    for role in ROLES:
        assert jpaths[role].split("/")[-1] == tpaths[role].split("/")[-1]
        assert_same_leaves(tcw.load_torch_state_dict(tpaths[role]),
                           jcw.load_torch_state_dict(jpaths[role]))
    raw = torch.load(tpaths["beats"], weights_only=False)
    assert raw["cfg"] == {"fabricated": True} and "model" in raw


# --------------------------------------------------------------------------
# converters
# --------------------------------------------------------------------------


@pytest.mark.parametrize("what", ["eva", "video_bundle", "audio_bundle", "blip2_fallback",
                                  "beats", "llama", "llama_int8", "llama_fp16_int8"])
def test_converter_gives_jax_tree(ckpt, what):
    qcfg = tiny_model_config().qformer
    lcfg = tiny_model_config(quantization="int8").llm
    if what == "eva":
        sd = tcw.load_torch_state_dict(ckpt["vit"])
        pair = tcw.convert_eva_vit(sd, tiny_model_config().vit), jcw.convert_eva_vit(sd, j_tiny().vit)
        k_bias = pair[0]["block_0"]["attn"]["k"]["bias"]
        assert not k_bias.any() and k_bias.dtype == np.float32       # no key bias in EVA
    elif what in ("video_bundle", "audio_bundle"):
        modality = what.split("_")[0]
        sd = tcw.load_torch_state_dict(ckpt[f"{modality}_qformer"])
        pair = (tcw.convert_qformer_bundle(sd, qcfg, modality),
                jcw.convert_qformer_bundle(sd, j_tiny().qformer, modality))
        assert sorted(pair[0]) == [f"{modality}_{s}" for s in ("ln", "proj", "qformer",
                                                               "query_tokens")]
    elif what == "blip2_fallback":
        sd = tcw.load_torch_state_dict(ckpt["blip2"])
        pair = ({m: tcw.convert_qformer_bundle(sd, qcfg, m) for m in ("video", "audio")},
                {m: jcw.convert_qformer_bundle(sd, j_tiny().qformer, m) for m in ("video", "audio")})
    elif what == "beats":
        sd = tcw.load_torch_state_dict(ckpt["beats"])
        pair = tcw.convert_beats(sd, tiny_model_config().beats), jcw.convert_beats(sd, j_tiny().beats)
        assert "pos_conv" in pair[0] and "encoder.pos_conv.0.weight_g" in sd
    else:
        sd = tcw.load_torch_state_dict(ckpt["llm"])
        if what == "llama_fp16_int8":
            sd = {k: v.astype(np.float16) for k, v in sd.items()}
        pair = (tcw.convert_llama_hf(sd, lcfg),
                jcw.convert_llama_hf(sd, j_tiny(quantization="int8").llm))
        emb = pair[0]["embed_tokens"]["embedding"]
        assert emb.shape[0] == lcfg.padded_vocab_size > sd["model.embed_tokens.weight"].shape[0]
        assert not emb[sd["model.embed_tokens.weight"].shape[0]:].any()      # the [PAD] rows
        if what != "llama":
            pair = tcw.quantize_llama_int8(pair[0]), jcw.quantize_llama_int8(pair[1])
            leaf = pair[0]["layer_0"]["attn"]["q_proj"]
            assert sorted(leaf) == ["scale", "w_int8"] and leaf["w_int8"].dtype == np.int8
            assert pair[0]["lm_head"]["kernel"].dtype == sd["lm_head.weight"].dtype
    assert_same_leaves(flat(pair[0]), flat(pair[1]))


def test_llama_tied_head_and_bias_flavours(ckpt):
    lcfg = tiny_model_config().llm
    jl = j_tiny().llm
    sd = tcw.load_torch_state_dict(ckpt["llm"])
    tied = {k: v for k, v in sd.items() if k != "lm_head.weight"}
    ours, theirs = tcw.convert_llama_hf(tied, lcfg), jcw.convert_llama_hf(tied, jl)
    assert_same_leaves(flat(ours), flat(theirs))
    np.testing.assert_array_equal(ours["lm_head"]["kernel"].T, ours["embed_tokens"]["embedding"])
    # Qwen2-flavour biases: converted when the config asks, refused otherwise
    biased = tfab.fabricate_llama_hf_sd(lcfg.replace(attention_bias=True))
    assert_same_leaves(flat(tcw.convert_llama_hf(biased, lcfg.replace(attention_bias=True))),
                       flat(jcw.convert_llama_hf(biased, jl.replace(attention_bias=True))))
    for sd_, cfg_, jcfg_, match in ((biased, lcfg, jl, "Qwen2 flavor"),
                                    (sd, lcfg.replace(attention_bias=True),
                                     jl.replace(attention_bias=True), "wrong decoder flavor")):
        with pytest.raises(ValueError, match=match):
            jcw.convert_llama_hf(sd_, jcfg_)
        with pytest.raises(ValueError, match=match):
            tcw.convert_llama_hf(sd_, cfg_)


def test_unported_cases_name_their_item():
    for fn, args, item in ((tcw.quantize_llama_int4, ({},), "A.2"),
                           (tcw.stack_llm_layers, ({}, 2), "A.2")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
            fn(*args)
    for field, value in (("quantization", "int4"), ("scan_layers", True)):
        cfg = RunConfig(model=tiny_model_config())
        cfg = cfg.replace(model=cfg.model.replace(llm=cfg.model.llm.replace(**{field: value})))
        with pytest.raises(NotImplementedError, match="ROADMAP.md A.2"):
            tcw.load_pretrained_params(None, cfg)
    # VideoLLaMA (ROADMAP.md A.6) is ported: the factory builds it
    from mraudio_tpu_torch.models.videollama import VideoLLaMA

    assert isinstance(build_model(RunConfig(model_name="VideoLLaMA", model=tiny_model_config()),
                                  "cpu"), VideoLLaMA)
    with pytest.raises(ValueError, match="unknown model"):
        build_model(RunConfig(model_name="GPT", model=tiny_model_config()), "cpu")


# --------------------------------------------------------------------------
# load_pretrained_params: the port's modules against JAX's tree
# --------------------------------------------------------------------------


def test_flax_layout_names_and_shapes_are_jax():
    """``flax_params`` gives the JAX tree's flat names and shapes (the
    param store's keys), for float and int8 weights."""
    for quantization in ("none", "int8"):
        jcfg, tcfg = configs(quantization)
        jm = JModel(jcfg.model, audio_cfg=jcfg.data.audio)
        shapes = flat(jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0), jit=False)))
        ours = flax_params(build_model(tcfg, "cpu"))
        assert sorted(ours) == sorted(shapes)
        for k, t in ours.items():
            assert tuple(t.shape) == tuple(shapes[k].shape), k


@pytest.mark.parametrize("vicuna_dtype", ["float32", "float16"])
def test_load_pretrained_params_matches_jax(ckpt, tmp_path, monkeypatch, vicuna_dtype):
    """Every leaf the six artifacts cover, in both packages, bit for bit
    and in the same dtype, before and after the inference cast; the
    uncovered leaves are the same (LoRA's A and B only)."""
    paths = dict(ckpt)
    if vicuna_dtype == "float16":
        sd = torch.load(ckpt["llm"])
        paths["llm"] = str(tmp_path / "vicuna_fp16.pth")
        torch.save({k: v.half() for k, v in sd.items()}, paths["llm"])
    jcfg, tcfg = configs("int8", **{WEIGHT_FIELDS[r]: p for r, p in paths.items()})
    with jax_init_filled():
        jm = JModel(jcfg.model, audio_cfg=jcfg.data.audio)
        theirs = jcw.load_pretrained_params(jm, jcfg)
    monkeypatch.setattr(tcw, "init_random_", _sentinel_)
    model = tcw.load_pretrained_params(build_model(tcfg, "cpu"), tcfg)
    ours = flax_params(model)
    assert_same_leaves(ours, flat(theirs))
    uncovered = sorted(k for k, v in ours.items() if v.is_floating_point() and v.isnan().all())
    assert uncovered and all(k.split("/")[-1] in ("lora_a", "lora_b") for k in uncovered)
    assert len(uncovered) == sum(k.endswith(("lora_a", "lora_b")) for k in ours)
    assert ours["llm/final_norm/scale"].dtype == getattr(torch, vicuna_dtype)
    assert_same_leaves(flax_params(cast_params_for_inference(model)), flat(j_cast(theirs)))


def test_seeded_init_under_the_overlay(ckpt):
    """Without the sentinel, the leaves no artifact covers are the seeded
    init's: LoRA A random, LoRA B zero, so the converted model computes
    the JAX package's function (B zero makes the delta vanish)."""
    _, tcfg = configs("int8", **{WEIGHT_FIELDS[r]: p for r, p in ckpt.items()})
    ours = flax_params(tcw.load_pretrained_params(build_model(tcfg, "cpu"), tcfg))
    lora_b = [v for k, v in ours.items() if k.endswith("lora_b")]
    lora_a = [v for k, v in ours.items() if k.endswith("lora_a")]
    assert lora_b and all(not v.any() for v in lora_b)
    assert all(v.abs().sum() > 0 for v in lora_a)


# --------------------------------------------------------------------------
# ROADMAP C.1: the LoRA delta with a non-zero B
# --------------------------------------------------------------------------


def test_lora_delta_with_nonzero_b_matches_jax(ckpt):
    """A converted tiny decoder (f32, int8 weights) with a seeded non-zero
    LoRA B in every target: the port's logits are JAX's on the CPU within
    f32 rounding (rtol = atol = 1e-4, as ``test_torch_llama.py``).
    That the delta keeps a row's bits at any row count is a property of
    the card; ``chip_smoke.py``'s identity phases check it there."""
    kw = dict(vocab_size=260, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=4,
              intermediate_size=128, max_seq_len=256, dtype="float32", quantization="int8")
    jcfg, tcfg = JLlamaConfig(**kw), LlamaConfig(**kw)
    rng = np.random.default_rng(7)
    tree = tcw.quantize_llama_int8(tcw.convert_llama_hf(tcw.load_torch_state_dict(ckpt["llm"]),
                                                        tcfg))
    shapes = flat(jax.eval_shape(lambda: JLlama(jcfg, JLoraConfig(rank=2, alpha=2)).init(
        jax.random.PRNGKey(0), np.zeros((1, 4, 64), np.float32), np.ones((1, 1, 4, 4), bool),
        np.zeros((1, 4), np.int32), np.zeros((1, 4), np.int32),
        method=JLlama.init_all)["params"]))
    for k, v in shapes.items():
        if k.endswith(("lora_a", "lora_b")):
            *scope, leaf = k.split("/")
            node = tree
            for s in scope:
                node = node[s]
            node[leaf] = (rng.standard_normal(v.shape) * 0.05).astype(np.float32)
    model = load_jax_params_(LlamaModel(tcfg, LoraConfig(rank=2, alpha=2)), tree)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    mask = np.tril(np.ones((5, 5), bool))[None, None]
    pos = np.broadcast_to(np.arange(5, dtype=np.int32), (3, 5)).copy()
    ref, _ = JLlama(jcfg, JLoraConfig(rank=2, alpha=2)).apply({"params": tree}, x, mask, pos)
    with torch.no_grad():
        out, _ = model(torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    # the delta is not negligible: dropping it moves the logits by 10x the tolerance
    with torch.no_grad():
        for mod in model.modules():
            if getattr(mod, "lora_scale", 0):
                mod.lora_b.zero_()
        bare, _ = model(torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(pos))
    assert float((bare - out).abs().max()) > 1e-3
