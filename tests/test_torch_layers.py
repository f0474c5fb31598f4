"""Port parity: shared layers and the audio/video frontends against the
JAX package, on the CPU, from the same numpy inputs and flax params."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mraudio_tpu.config import AudioFrontendConfig as JAudioCfg
from mraudio_tpu.models import layers as jl
from mraudio_tpu.ops.fbank import beats_frontend as j_beats_frontend
from mraudio_tpu.ops.fbank import kaldi_fbank as j_kaldi_fbank
from mraudio_tpu.ops.image import normalize_frames as j_normalize_frames
from mraudio_tpu_torch.config import AudioFrontendConfig
from mraudio_tpu_torch.models import layers as tl
from mraudio_tpu_torch.models.convert_jax import load_jax_params_
from mraudio_tpu_torch.ops.fbank import beats_frontend, kaldi_fbank
from mraudio_tpu_torch.ops.image import normalize_frames

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return np.asarray(x.detach().float().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _init(module, *args):
    return jax.device_get(module.init(jax.random.PRNGKey(0), *args)["params"])


def test_layer_norm_fp32_matches():
    x = np.random.default_rng(0).standard_normal((2, 5, 16)).astype(np.float32) * 3 + 1
    jm = jl.LayerNormFp32(epsilon=1e-6)
    params = _init(jm, jnp.asarray(x))
    params["LayerNorm_0"]["scale"] = np.linspace(0.5, 1.5, 16, dtype=np.float32)
    params["LayerNorm_0"]["bias"] = np.linspace(-0.2, 0.2, 16, dtype=np.float32)
    ref = jm.apply({"params": params}, jnp.asarray(x))
    tm = load_jax_params_(tl.LayerNormFp32(16, 1e-6), params)
    np.testing.assert_allclose(_np(tm(torch.from_numpy(x))), _np(ref), **TOL)


def test_rms_norm_matches():
    x = np.random.default_rng(1).standard_normal((2, 5, 16)).astype(np.float32)
    jm = jl.RMSNorm(epsilon=1e-6)
    params = _init(jm, jnp.asarray(x))
    params["scale"] = np.linspace(0.5, 1.5, 16, dtype=np.float32)
    ref = jm.apply({"params": params}, jnp.asarray(x))
    tm = load_jax_params_(tl.RMSNorm(16, 1e-6), params)
    np.testing.assert_allclose(_np(tm(torch.from_numpy(x))), _np(ref), **TOL)


def test_gelu_exact_matches():
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    np.testing.assert_allclose(_np(tl.gelu_exact(torch.from_numpy(x))),
                               _np(jl.gelu_exact(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("with_bias", [False, True])
def test_dot_product_attention_matches(with_bias):
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, n, 3, 8)).astype(np.float32) for n in (5, 7, 7))
    mask = rng.random((2, 1, 5, 7)) > 0.3
    mask[..., 0] = True
    bias = rng.standard_normal((1, 3, 5, 7)).astype(np.float32) if with_bias else None
    ref = jl.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   mask=jnp.asarray(mask),
                                   bias=None if bias is None else jnp.asarray(bias))
    out = tl.dot_product_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                   mask=torch.from_numpy(mask),
                                   bias=None if bias is None else torch.from_numpy(bias))
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)


@pytest.mark.parametrize("cross", [False, True])
def test_attention_module_matches(cross):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    kv = rng.standard_normal((2, 9, 24)).astype(np.float32) if cross else None
    mask = np.ones((2, 1, 1, 9 if cross else 5), bool)
    mask[1, ..., -2:] = False
    jm = jl.Attention(num_heads=4, dtype=jnp.float32)
    jargs = (jnp.asarray(x), None if kv is None else jnp.asarray(kv), jnp.asarray(mask))
    params = _init(jm, *jargs)
    ref = jm.apply({"params": params}, *jargs)
    tm = load_jax_params_(
        tl.Attention(16, 4, kv_features=24 if cross else None, dtype=torch.float32), params)
    out = tm(torch.from_numpy(x), None if kv is None else torch.from_numpy(kv),
             mask=torch.from_numpy(mask))
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)


def test_mlp_matches():
    x = np.random.default_rng(4).standard_normal((2, 5, 16)).astype(np.float32)
    jm = jl.Mlp(hidden_dim=32, dtype=jnp.float32)
    params = _init(jm, jnp.asarray(x))
    ref = jm.apply({"params": params}, jnp.asarray(x))
    tm = load_jax_params_(tl.Mlp(16, 32, dtype=torch.float32), params)
    np.testing.assert_allclose(_np(tm(torch.from_numpy(x))), _np(ref), **TOL)


def test_positions_from_mask_matches():
    mask = np.array([[0, 0, 1, 1, 0, 1], [1, 1, 1, 0, 1, 1]], np.int32)
    np.testing.assert_array_equal(
        tl.positions_from_mask(torch.from_numpy(mask)).numpy(),
        np.asarray(jl.positions_from_mask(jnp.asarray(mask))))


def test_normalize_frames_matches():
    frames = np.random.default_rng(5).integers(0, 256, (2, 3, 4, 4, 3), dtype=np.uint8)
    ref = j_normalize_frames(jnp.asarray(frames), dtype=jnp.float32)
    out = normalize_frames(torch.from_numpy(frames), dtype=torch.float32)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)


def test_kaldi_fbank_matches():
    wave = np.random.default_rng(6).standard_normal((2, 4000)).astype(np.float32) * 3000
    ref = j_kaldi_fbank(jnp.asarray(wave), num_mel_bins=16)
    out = kaldi_fbank(torch.from_numpy(wave), num_mel_bins=16)
    assert out.shape == ref.shape
    # log-mels of int16-scale audio are O(10); f32 FFTs differ in rounding
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n_frms,integer", [(4, True), (40, False)])
def test_beats_frontend_matches(n_frms, integer):
    rng = np.random.default_rng(7)
    if integer:
        wave = rng.integers(-3000, 3000, (2, 8000), dtype=np.int16)
    else:
        wave = (rng.standard_normal((2, 8000)) * 0.1).astype(np.float32)
    kw = dict(num_mel_bins=16, mel_frames_per_chunk=8)
    ref = j_beats_frontend(jnp.asarray(wave), JAudioCfg(**kw), n_frms)
    out = beats_frontend(torch.from_numpy(wave), AudioFrontendConfig(**kw), n_frms)
    assert out.shape == ref.shape  # (40 * 8 > 48 mel frames: zero-padded tail)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-5, atol=1e-5)
