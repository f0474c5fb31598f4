"""The train-time augmentation against the JAX package's
(``ops/image.py``): ``sample_crop_params`` draws the same int32 arrays
from the same generator, and ``augment_and_normalize`` (crop, flip,
bilinear resize with JAX's antialiased triangle kernel, CLIP
normalization) agrees on RGB frames and on the yuv420 wire.

The reference is JAX's function run op by op (``jax.disable_jit``): the
port computes the same float32 operations in the same order (the
resampling weights bit for bit, rows contracted before columns) and
agrees within atol 1e-6.  Compiled, XLA fuses the weight arithmetic into
multiply-adds and rewrites divisions, which moves JAX's own result by up
to ~1.3e-5 from its op-by-op result; the compiled function is held at
3e-5 at the trainer's output size."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mraudio_tpu.ops import image as jimage
from mraudio_tpu_torch.ops import image as timage

torch.set_num_threads(1)


def _inputs(seed, b=3, t=4, size=28):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (b, t, size, size, 3)).astype(np.uint8)
    crop = jimage.sample_crop_params(np.random.default_rng((seed, 1)), b, size, size, 0.5, 1.0)
    crop[:, 4] = np.arange(b) % 2          # both flips
    return frames, crop


@pytest.mark.parametrize("scale", [(0.9, 1.0), (0.3, 0.6), (1.2, 1.5)])
def test_crop_params_bit_identical(scale):
    for seed in range(20):
        ours = timage.sample_crop_params(np.random.default_rng((59, seed)), 4, 224, 180, *scale)
        theirs = jimage.sample_crop_params(np.random.default_rng((59, seed)), 4, 224, 180, *scale)
        assert ours.dtype == theirs.dtype == np.int32
        np.testing.assert_array_equal(ours, theirs)


def _port(frames, crop, out):
    return timage.augment_and_normalize(torch.as_tensor(frames), torch.from_numpy(crop), out,
                                        dtype=torch.float32).numpy()


@pytest.mark.parametrize("out", [28, 32, 20])
def test_augment_rgb(out):
    frames, crop = _inputs(out)
    ours = _port(frames, crop, out)
    with jax.disable_jit():
        eager = np.asarray(jimage.augment_and_normalize(jnp.asarray(frames), jnp.asarray(crop),
                                                        out, dtype=jnp.float32))
    assert ours.shape == (3, 4, out, out, 3)
    np.testing.assert_allclose(ours, eager, rtol=0, atol=1e-6)
    if out == 28:       # one compile: the trainer's output size
        compiled = np.asarray(jimage.augment_and_normalize(
            jnp.asarray(frames), jnp.asarray(crop), out, dtype=jnp.float32))
        np.testing.assert_allclose(ours, compiled, rtol=0, atol=3e-5)


def test_augment_on_the_yuv420_wire():
    frames, crop = _inputs(7)
    wire = timage.rgb_to_yuv420(frames)
    np.testing.assert_array_equal(wire, np.asarray(jimage.rgb_to_yuv420(frames)))
    ours = _port(timage.yuv420_to_rgb(torch.from_numpy(wire)), crop, 28)
    with jax.disable_jit():
        eager = np.asarray(jimage.augment_and_normalize(
            jimage.yuv420_to_rgb(jnp.asarray(wire)), jnp.asarray(crop), 28, dtype=jnp.float32))
    np.testing.assert_allclose(ours, eager, rtol=0, atol=1e-6)


def test_bf16_output():
    frames, crop = _inputs(3)
    out = timage.augment_and_normalize(torch.from_numpy(frames), torch.from_numpy(crop), 28)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(),
                                  torch.from_numpy(_port(frames, crop, 28)).bfloat16().float())
