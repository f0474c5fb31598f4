"""The evaluate CLI's ``--fast`` path in the port against the JAX package:
the temporal-residual ViT, the yuv420 wire (host packing, device
unpacking, the dataset's I420 route, the native I420 decode), the preset
itself, and ``cli.evaluate --fast`` end to end.

Tolerances: the residual ViT within 2e-5 of JAX's in f32 (f32 sums in
other orders; the JAX package's own tolerance for this path), also on a
clip whose patch differences tie exactly; ``yuv420_to_rgb`` within 1e-3
of JAX's (its own tolerance); everything else exact — the packed bytes,
the dataset's arrays, the native decode and the evaluate CLI's JSONL."""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mraudio_tpu.config import RunConfig as JRunConfig
from mraudio_tpu.config import ViTConfig as JViTConfig
from mraudio_tpu.config import apply_fast_preset as j_apply_fast_preset
from mraudio_tpu.config import tiny_data_config as j_tiny_data
from mraudio_tpu.config import tiny_model_config as j_tiny
from mraudio_tpu.data import native_bindings as j_nb
from mraudio_tpu.data.dataset import MRDataset as JDataset
from mraudio_tpu.data.dataset import collate as j_collate
from mraudio_tpu.data.video import NativeVideoSource as JNativeVideo
from mraudio_tpu.infer.evaluate import run_inference as j_run_inference
from mraudio_tpu.models.eva_vit import EvaViT as JEvaViT
from mraudio_tpu.models.xinstructblip import XInstructBLIP as JModel
from mraudio_tpu.ops.image import rgb_to_yuv420 as j_rgb_to_yuv420
from mraudio_tpu.ops.image import yuv420_to_rgb as j_yuv420_to_rgb
from mraudio_tpu_torch.cli import evaluate as cli_evaluate
from mraudio_tpu_torch.config import RunConfig, ViTConfig, apply_fast_preset, tiny_data_config
from mraudio_tpu_torch.data import native_bindings
from mraudio_tpu_torch.data.dataset import MRDataset, collate
from mraudio_tpu_torch.data.video import NativeVideoSource
from mraudio_tpu_torch.eval.mr_eval import eval_submission
from mraudio_tpu_torch.infer.evaluate import build_model
from mraudio_tpu_torch.models.convert_jax import load_jax_params_, torch_name
from mraudio_tpu_torch.models.eva_vit import EvaViT
from mraudio_tpu_torch.ops.image import rgb_to_yuv420, yuv420_to_rgb

torch.set_num_threads(1)

VIT = dict(image_size=56, patch_size=14, width=32, depth=2, num_heads=2, mlp_dim=64,
           dtype="float32")                         # a 4 x 4 grid: 16 patches


def _vit_pair(**kw):
    jvit = JEvaViT(JViTConfig(**VIT, **kw))
    params = jax.device_get(jvit.init(jax.random.PRNGKey(0), jnp.zeros((1, 56, 56, 3)))["params"])
    return jvit, params, load_jax_params_(EvaViT(ViTConfig(**VIT, **kw)), params)


def _clips(b, t, seed):
    """Frames of a static scene in which only a few patches move, so most
    patch differences against the keyframe are exactly 0 (tied)."""
    rng = np.random.default_rng(seed)
    frames = np.repeat(rng.normal(size=(b, 1, 56, 56, 3)), t, axis=1).astype(np.float32)
    frames[:, 1:, :14, 14:42] += rng.normal(size=(b, t - 1, 14, 28, 3)).astype(np.float32)
    frames[:, 3:, 42:, :14] += 0.5
    return frames.reshape(b * t, 56, 56, 3)


def test_residual_vit_matches_jax_with_tied_patches():
    b, t = 2, 6
    jvit, params, tvit = _vit_pair(keyframe_interval=3, residual_tokens=5)
    x = _clips(b, t, seed=1)
    ref = np.asarray(jax.jit(lambda p, x: jvit.apply({"params": p}, x, n_frms=t))(params, x))
    with torch.inference_mode():
        got = tvit(torch.from_numpy(x), n_frms=t).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    # without n_frms every frame takes the full path, and the residual
    # frames really differ from it
    with torch.inference_mode():
        full = tvit(torch.from_numpy(x)).numpy()
    assert np.abs(full - got).max() > 1e-3


def test_residual_vit_with_every_patch_is_the_full_path():
    b, t = 2, 4
    _, params, tvit = _vit_pair(keyframe_interval=2, residual_tokens=16)
    plain = load_jax_params_(EvaViT(ViTConfig(**VIT)), params)
    x = torch.from_numpy(_clips(b, t, seed=2))
    with torch.inference_mode():
        np.testing.assert_allclose(tvit(x, n_frms=t).numpy(), plain(x).numpy(),
                                   rtol=2e-5, atol=2e-5)


def test_yuv420_wire_matches_jax():
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (2, 3, 28, 36, 3), dtype=np.uint8)
    packed = rgb_to_yuv420(frames)
    ref = j_rgb_to_yuv420(frames)
    assert packed.dtype == np.uint8 and packed.shape == (2, 3, 42, 36)
    assert packed.tobytes() == np.asarray(ref).tobytes()
    rgb = yuv420_to_rgb(torch.from_numpy(packed)).numpy()
    np.testing.assert_allclose(rgb, np.asarray(j_yuv420_to_rgb(jnp.asarray(packed))),
                               rtol=0, atol=1e-3)
    assert rgb.dtype == np.float32 and rgb.shape == frames.shape
    gray = np.full((1, 8, 8, 3), 100, np.uint8)  # no chroma to lose: back within a count
    assert np.abs(yuv420_to_rgb(torch.from_numpy(rgb_to_yuv420(gray))).numpy() - 100).max() < 1


def _annotations(n=5):
    return [{"vid": f"v{i}", "qid": i, "query": f"a person does action {i}",
             "duration": 150 - 7 * i, "relevant_windows": [[10 + i, 30 + i]]} for i in range(n)]


def test_dataset_yuv420_route_matches_jax():
    cfg = tiny_data_config(n_frms=4).replace(video_wire="yuv420")
    jcfg = j_tiny_data(n_frms=4).replace(video_wire="yuv420")
    anns = _annotations(3)
    ds, jds = MRDataset(cfg, annotations=anns), JDataset(jcfg, annotations=anns)
    batch = collate([ds.get(i) for i in range(3)], 3)
    jbatch = j_collate([jds.get(i) for i in range(3)], 3)
    assert batch.video.shape == (3, 4, 42, 28) and batch.video.dtype == np.uint8
    np.testing.assert_array_equal(batch.video, jbatch.video)
    np.testing.assert_array_equal(batch.audio, jbatch.audio)
    np.testing.assert_array_equal(ds._blank_sample(0).video, jds._blank_sample(0).video)


def test_native_i420_decodes_identically(tmp_path):
    """A clip decoded to the I420 wire by both packages' native sources."""
    try:
        lib = native_bindings.load()
        j_nb.load()
    except (native_bindings.NativeUnavailable, j_nb.NativeUnavailable) as exc:
        pytest.skip(f"native library unavailable: {exc}")
    n, h, w = 16, 64, 64
    frames = np.zeros((n, h, w, 3), np.uint8)
    for i in range(n):
        frames[i] = int(255 * i / (n - 1))
        frames[i, : h // 2, :, 1] = 255 - frames[i, 0, 0, 0]
    path = str(tmp_path / "clip.mp4")
    native_bindings.write_test_video(lib, path, frames, 12.0)
    idx = np.array([0, 3, 7, 15])
    got = NativeVideoSource().get_batch_i420(path, idx, 32, 48)
    np.testing.assert_array_equal(got, JNativeVideo().get_batch_i420(path, idx, 32, 48))
    assert got.shape == (4, 48, 48) and got.std() > 0


def test_fast_preset_matches_jax():
    got = apply_fast_preset(RunConfig())
    ref = j_apply_fast_preset(JRunConfig())
    for key in ("keyframe_interval", "residual_tokens"):
        assert getattr(got.model.vit, key) == getattr(ref.model.vit, key)
    for key in ("constrained_decoding", "spec_width", "lookup_spec", "video_wire"):
        assert getattr(got.model, key) == getattr(ref.model, key)
    assert got.data.video_wire == ref.data.video_wire == "yuv420"


def _jax_tree_from_port(model, jtree):
    """The port's parameters in the JAX package's tree layout (the
    inverse of ``load_jax_params_``); ``jtree`` gives the leaves' shapes
    and dtypes."""
    params = dict(model.named_parameters())

    def fill(tree, path):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fill(v, path + (k,))
                continue
            name = torch_name(path + (k,))
            a = params[name].detach().numpy()
            if name.endswith("pos_conv.kernel"):
                a = a.transpose(2, 1, 0)
            out[k] = a.reshape(v.shape).astype(v.dtype)
        return out

    return fill(jtree, ())


def test_cli_fast_matches_jax_run_inference(tmp_path):
    """``cli.evaluate --fast`` on the CPU (the tiny model in f32 with int8
    weights and an int8 KV cache, from a JAX package YAML) writes the JSONL
    of the JAX package's ``run_inference`` under ``apply_fast_preset`` on
    the same seeded weights, and every prediction parses."""
    model = j_tiny().replace(max_new_tokens=16)
    llm = model.llm.replace(dtype="float32", quantization="int8", kv_quant="int8",
                            prefill_chunk=64)
    model = model.replace(llm=llm, vit=model.vit.replace(dtype="float32"),
                          beats=model.beats.replace(dtype="float32"),
                          qformer=model.qformer.replace(dtype="float32"))
    config = tmp_path / "run.yaml"
    JRunConfig(model=model, data=j_tiny_data(n_frms=4)).to_yaml(str(config))
    gt, out = tmp_path / "gt.jsonl", tmp_path / "port.jsonl"
    anns = _annotations(5)
    gt.write_text("".join(json.dumps(a) + "\n" for a in anns))
    result = cli_evaluate.main(["--annotation-file", str(gt), "--output-file", str(out),
                                "--config", str(config), "--fast", "--model-size", "tiny",
                                "--video-source", "synthetic", "--device", "cpu",
                                "--batch-size", "2", "--num-workers", "1"])

    jcfg = j_apply_fast_preset(JRunConfig.from_yaml(str(config)))
    jcfg = jcfg.replace(data=jcfg.data.replace(video_source="synthetic"))
    jm = JModel(jcfg.model, audio_cfg=jcfg.data.audio)
    port = build_model(apply_fast_preset(RunConfig.from_yaml(str(config))), device="cpu")
    params = _jax_tree_from_port(port, jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)))
    jout = tmp_path / "jax.jsonl"
    ref = j_run_inference(jcfg, model=jm, params=params, annotations=anns,
                          output_file=str(jout), batch_size=2, num_workers=1)
    assert result["records"] == ref["records"]
    assert out.read_bytes() == jout.read_bytes()
    brief = eval_submission(result["records"], anns, verbose=False)["brief"]
    assert brief["MR-full-invalid_pred_num"] == 0
    assert all(bt["decode_steps"] < 16 and len(bt["decode_tokens"]) == 2
               for bt in result["batches"])
