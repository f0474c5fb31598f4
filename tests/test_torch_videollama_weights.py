"""The port's VideoLLaMA converters, loader and param store against the
JAX package's, on synthetic merged checkpoints in the VideoLLaMA2-AV key
layout at the tiny size: a CLIP tower with a Llama decoder (the JAX
wiring test's fabricator), and a SigLIP tower with a Qwen2 decoder (q/k/v
biases, 2 KV heads), projector readouts, the projector's conv keys that
the pooling connector drops, and the towers' heads and final norms.

Bit for bit, no tolerance: ``convert_clip_vit_hf``,
``convert_siglip_vit_hf`` (and its refusal of a class-token config),
``convert_videollama`` and the Qwen2 flavour of ``convert_llama_hf`` give
JAX's trees, leaf for leaf; ``load_pretrained_params`` for VideoLLaMA
(the merged checkpoint, int8 too, with a BEATs checkpoint overlaid) puts
into the port's modules what JAX's overlay puts into its tree, and the
convert CLI writes JAX's store.  Both random inits are replaced by one
sentinel fill (NaN, int8 -128), so an uncovered leaf shows: only the LoRA
adapters are.  int4 weights and the ``scan_layers`` layout keep raising,
naming ROADMAP.md A.2."""

import contextlib
import logging

import numpy as np
import pytest

import jax
import torch

import mraudio_tpu.models.convert_weights as jcw
from mraudio_tpu.cli import convert as j_cli_convert
from mraudio_tpu.config import LlamaConfig as JLlamaConfig
from mraudio_tpu.config import RunConfig as JRunConfig
from mraudio_tpu.config import tiny_data_config as j_tiny_data
from mraudio_tpu.config import tiny_model_config as j_tiny
from mraudio_tpu.models.videollama import VideoLLaMA as JVideoLLaMA
from mraudio_tpu.models.videollama import videollama_config_from as j_config_from
import mraudio_tpu_torch.models.convert_weights as tcw
from mraudio_tpu_torch.cli import convert as cli_convert
from mraudio_tpu_torch.config import LlamaConfig, RunConfig, tiny_data_config, tiny_model_config
from mraudio_tpu_torch.models.convert_jax import flax_params
from mraudio_tpu_torch.models.factory import build_model
from mraudio_tpu_torch.models.videollama import VideoLLaMA, videollama_config_from
from test_torch_convert_weights import _fill, _sentinel_, assert_same_leaves, flat
from tests.test_beats_gates import synthetic_beats_sd
from tests.test_videollama_wiring import _synthetic_videollama_ckpt

torch.set_num_threads(1)

VISION = "model.vision_tower.vision_tower.vision_model."


def qwen2_siglip_ckpt(vcfg, rng) -> dict:
    """A merged 2.1-AV-layout state dict for ``vcfg`` (a SigLIP tower
    without a class token, a Qwen2 decoder with q/k/v biases)."""
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    vit, llm, beats = vcfg.vit, vcfg.llm, vcfg.beats
    d, p, h = vit.width, vit.patch_size, llm.hidden_size
    sd = {VISION + "embeddings.patch_embedding.weight": f32(d, 3, p, p),
          VISION + "embeddings.patch_embedding.bias": f32(d),
          VISION + "embeddings.position_embedding.weight": f32(vit.num_patches, d),
          VISION + "post_layernorm.weight": f32(d), VISION + "post_layernorm.bias": f32(d),
          VISION + "head.probe": f32(1, 1, d)}
    for i in range(vit.depth):
        pre = f"{VISION}encoder.layers.{i}"
        for ln in ("layer_norm1", "layer_norm2"):
            sd[f"{pre}.{ln}.weight"], sd[f"{pre}.{ln}.bias"] = f32(d), f32(d)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{pre}.self_attn.{proj}.weight"] = f32(d, d)
            sd[f"{pre}.self_attn.{proj}.bias"] = f32(d)
        for fc, shape in (("fc1", (vit.mlp_dim, d)), ("fc2", (d, vit.mlp_dim))):
            sd[f"{pre}.mlp.{fc}.weight"], sd[f"{pre}.mlp.{fc}.bias"] = f32(*shape), f32(shape[0])
    for name, width in (("mm_projector", d), ("mm_projector_a", beats.width)):
        sd[f"model.{name}.readout.0.weight"] = f32(h, width)
        sd[f"model.{name}.readout.0.bias"] = f32(h)
        sd[f"model.{name}.readout.2.weight"] = f32(h, h)
        sd[f"model.{name}.readout.2.bias"] = f32(h)
    sd["model.mm_projector.s1.b1.conv1.conv.weight"] = f32(h, d, 1, 1)
    sd["model.mm_projector.sampler.0.weight"] = f32(h, h, 3, 3, 3)
    for k, v in synthetic_beats_sd(beats, rng).items():
        sd[f"model.audio_tower.{k}"] = v
    kvd = llm.num_kv_heads * llm.head_dim
    sd["model.embed_tokens.weight"] = f32(llm.vocab_size, h)
    sd["model.norm.weight"] = f32(h)
    sd["lm_head.weight"] = f32(llm.vocab_size, h)
    for i in range(llm.num_layers):
        pre = f"model.layers.{i}"
        sd[f"{pre}.input_layernorm.weight"] = f32(h)
        sd[f"{pre}.post_attention_layernorm.weight"] = f32(h)
        for proj, out in (("q_proj", h), ("k_proj", kvd), ("v_proj", kvd)):
            sd[f"{pre}.self_attn.{proj}.weight"] = f32(out, h)
            sd[f"{pre}.self_attn.{proj}.bias"] = f32(out)
        sd[f"{pre}.self_attn.o_proj.weight"] = f32(h, h)
        sd[f"{pre}.mlp.gate_proj.weight"] = f32(llm.intermediate_size, h)
        sd[f"{pre}.mlp.up_proj.weight"] = f32(llm.intermediate_size, h)
        sd[f"{pre}.mlp.down_proj.weight"] = f32(h, llm.intermediate_size)
    return sd


def _model_cfg(tiny, flavour, quantization="none"):
    """The tiny assembly config of one package (``tiny``) in f32, with the
    2.1-AV flavour's tower and decoder for ``flavour="qwen2"``."""
    m = tiny(quantization=quantization)
    m = m.replace(llm=m.llm.replace(dtype="float32"), vit=m.vit.replace(dtype="float32"),
                  beats=m.beats.replace(dtype="float32"))
    if flavour == "qwen2":
        m = m.replace(vit=m.vit.replace(use_class_token=False, mlp_act="gelu_tanh"),
                      llm=m.llm.replace(attention_bias=True, rope_theta=1e6, num_kv_heads=2))
    return m


def _ckpt(flavour):
    vcfg = videollama_config_from(_model_cfg(tiny_model_config, flavour), 4)
    if flavour == "clip":
        return _synthetic_videollama_ckpt(vcfg, np.random.default_rng(7))
    return qwen2_siglip_ckpt(vcfg, np.random.default_rng(8))


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """{flavour: merged checkpoint path}, and a BEATs checkpoint path."""
    root = tmp_path_factory.mktemp("vl_ck")
    paths = {}
    for flavour in ("clip", "qwen2"):
        paths[flavour] = str(root / f"{flavour}.pth")
        torch.save({k: torch.from_numpy(v) for k, v in _ckpt(flavour).items()}, paths[flavour])
    beats = synthetic_beats_sd(tiny_model_config().beats, np.random.default_rng(9))
    paths["beats"] = str(root / "beats.pt")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in beats.items()}}, paths["beats"])
    return paths


@contextlib.contextmanager
def jax_videollama_init_filled():
    """JAX's ``VideoLLaMA.init_params`` replaced by a NaN (int8: -128) fill
    of its shapes (``jax.eval_shape``)."""
    real = JVideoLLaMA.init_params

    def filled(self, rng, jit=None):
        return _fill(jax.eval_shape(lambda: real(self, rng, jit=False)), np.nan)

    JVideoLLaMA.init_params = filled
    try:
        yield
    finally:
        JVideoLLaMA.init_params = real


def _configs(flavour, quantization="none", **paths):
    return (JRunConfig(model_name="VideoLLaMA", model=_model_cfg(j_tiny, flavour, quantization),
                       data=j_tiny_data(n_frms=4), **paths),
            RunConfig(model_name="VideoLLaMA", model=_model_cfg(tiny_model_config, flavour,
                                                                quantization),
                      data=tiny_data_config(n_frms=4), **paths))


@pytest.mark.parametrize("flavour", ["clip", "qwen2"])
def test_converters_equal_jax(flavour, caplog):
    """The tower converter, the LLM converter and ``convert_videollama``
    give JAX's trees; the projector's conv keys are dropped with a log
    line."""
    sd = _ckpt(flavour)
    jcfg = j_config_from(_model_cfg(j_tiny, flavour), 4)
    tcfg = videollama_config_from(_model_cfg(tiny_model_config, flavour), 4)
    tower = "convert_clip_vit_hf" if flavour == "clip" else "convert_siglip_vit_hf"
    assert_same_leaves(flat(getattr(tcw, tower)(sd, tcfg.vit, prefix=VISION)),
                       flat(getattr(jcw, tower)(sd, jcfg.vit, prefix=VISION)))
    assert_same_leaves(flat(tcw.convert_llama_hf(sd, tcfg.llm)),
                       flat(jcw.convert_llama_hf(sd, jcfg.llm)))
    with caplog.at_level(logging.INFO, logger="mraudio_tpu_torch"):
        ours = tcw.convert_videollama(sd, tcfg)
    assert_same_leaves(flat(ours), flat(jcw.convert_videollama(sd, jcfg)))
    assert set(ours) == {"vit", "beats", "connector", "audio_proj", "llm"}
    dropped = [r.getMessage() for r in caplog.records if "dropped" in r.getMessage()]
    assert dropped == (["convert_videollama: dropped 2 mm_projector conv/downsample keys "
                        "(pooling connector has no counterpart)"] if flavour == "qwen2" else [])


def test_siglip_converter_refuses_a_class_token_config():
    cfg = tiny_model_config().vit
    with pytest.raises(ValueError, match="class token"):
        tcw.convert_siglip_vit_hf({}, cfg)
    with pytest.raises(ValueError, match="class token"):
        jcw.convert_siglip_vit_hf({}, j_tiny().vit)


@pytest.mark.parametrize("flavour,quantization", [("clip", "none"), ("clip", "int8"),
                                                  ("qwen2", "int8")])
def test_load_pretrained_params_equals_jax(ckpts, flavour, quantization, monkeypatch):
    """The merged checkpoint (int8: quantized by ``quantize_llama_int8``)
    and a BEATs checkpoint overlaid after it: every leaf JAX's, the LoRA
    adapters alone uncovered."""
    jcfg, tcfg = _configs(flavour, quantization, llm_weights=ckpts[flavour],
                          beats_weights=ckpts["beats"])
    with jax_videollama_init_filled():
        jm = JVideoLLaMA(j_config_from(jcfg.model, 4), audio_cfg=jcfg.data.audio)
        theirs = flat(jcw.load_pretrained_params(jm, jcfg))
    monkeypatch.setattr(tcw, "init_random_", _sentinel_)
    model = tcw.load_pretrained_params(build_model(tcfg, "cpu"), tcfg)
    assert isinstance(model, VideoLLaMA)
    ours = flax_params(model)
    assert_same_leaves(ours, theirs)
    uncovered = sorted(k for k, v in ours.items() if v.is_floating_point() and v.isnan().any())
    assert uncovered and all(k.endswith(("lora_a", "lora_b")) for k in uncovered)
    if quantization == "int8":
        assert ours["llm/layer_0/mlp/up_proj/w_int8"].dtype == torch.int8
    beats = tcw.load_torch_state_dict(ckpts["beats"])
    assert np.array_equal(ours["beats/pos_conv/bias"].numpy(), beats["encoder.pos_conv.0.bias"])


def test_convert_cli_store_equals_jax(ckpts, tmp_path, monkeypatch):
    """``cli.convert --model VideoLLaMA --model-path merged.pth`` writes the
    JAX convert CLI's store, leaf for leaf, and its meta."""
    args = ["--model", "VideoLLaMA", "--model-size", "tiny", "--model-path", ckpts["clip"]]
    with jax_videollama_init_filled():
        j_cli_convert.main([*args, "--output", str(tmp_path / "jax_store")])
    theirs = flat(j_cli_convert.load_param_store(str(tmp_path / "jax_store")))
    monkeypatch.setattr(tcw, "init_random_", _sentinel_)
    path = cli_convert.main([*args, "--output", str(tmp_path / "store.pt"), "--device", "cpu"])
    ours = torch.load(path, weights_only=True, mmap=True)
    assert_same_leaves(ours, theirs)
    assert cli_convert.load_store_meta(path) == {"model_name": "VideoLLaMA",
                                                 "quantization": "none", "scan_layers": False}


def test_int4_and_scan_layers_still_raise_a2():
    for change in (dict(quantization="int4"), dict(scan_layers=True)):
        cfg = RunConfig(model_name="VideoLLaMA", model=tiny_model_config(),
                        data=tiny_data_config(n_frms=4))
        cfg = cfg.replace(model=cfg.model.replace(llm=cfg.model.llm.replace(**change)))
        with pytest.raises(NotImplementedError, match="ROADMAP.md A.2"):
            build_model(cfg, "cpu")
        model = build_model(cfg.replace(model=tiny_model_config()), "cpu")
        model.cfg = model.cfg.replace(llm=model.cfg.llm.replace(**change))
        with pytest.raises(NotImplementedError, match="ROADMAP.md A.2"):
            tcw.load_pretrained_params(model, cfg)
    assert LlamaConfig().quantization == JLlamaConfig().quantization == "none"
