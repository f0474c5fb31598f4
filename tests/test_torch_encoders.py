"""Port parity: EVA-ViT, BEATs and the Q-Former at tiny-config widths,
f32, the same flax params loaded into the port."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mraudio_tpu.config import tiny_model_config as j_tiny
from mraudio_tpu.models.beats import BeatsEncoder as JBeats
from mraudio_tpu.models.eva_vit import EvaViT as JViT
from mraudio_tpu.models.qformer import QFormer as JQFormer
from mraudio_tpu_torch.config import tiny_model_config
from mraudio_tpu_torch.models.beats import BeatsEncoder
from mraudio_tpu_torch.models.convert_jax import load_jax_params_
from mraudio_tpu_torch.models.eva_vit import EvaViT
from mraudio_tpu_torch.models.qformer import QFormer

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)


def _f32(cfg):
    return cfg.replace(dtype="float32")


def _perturb(tree, rng):
    """Non-trivial norms/biases: the flax init leaves them at 1/0."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        else:
            v = np.asarray(v)
            if k in ("scale", "bias", "grep_a"):
                v = v + rng.uniform(-0.1, 0.1, v.shape).astype(v.dtype)
            out[k] = v
    return out


def test_eva_vit_matches():
    jcfg = _f32(j_tiny().vit)
    x = np.random.default_rng(0).standard_normal((3, 28, 28, 3)).astype(np.float32)
    jm = JViT(jcfg)
    params = _perturb(jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]),
                      np.random.default_rng(1))
    ref = jm.apply({"params": params}, jnp.asarray(x))
    tm = load_jax_params_(EvaViT(_f32(tiny_model_config().vit)), params)
    out = tm(torch.from_numpy(x))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("kernel", [8, 6])
def test_beats_matches(kernel):
    """Even conv_pos_kernel: the asymmetric (k//2, k//2 - 1) padding."""
    jcfg = _f32(j_tiny().beats).replace(conv_pos_kernel=kernel)
    fb = np.random.default_rng(2).standard_normal((2, 32, 16)).astype(np.float32)
    jm = JBeats(jcfg)
    params = _perturb(jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(fb))["params"]),
                      np.random.default_rng(3))
    ref = jm.apply({"params": params}, jnp.asarray(fb))
    tcfg = _f32(tiny_model_config().beats).replace(conv_pos_kernel=kernel)
    tm = load_jax_params_(BeatsEncoder(tcfg), params)
    out = tm(torch.from_numpy(fb))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_qformer_matches():
    jcfg = _f32(j_tiny().qformer)
    rng = np.random.default_rng(4)
    n, q, h, width = 3, jcfg.num_query_tokens, jcfg.hidden_size, 24
    query = rng.standard_normal((n, q, h)).astype(np.float32) * 0.02
    ids = rng.integers(3, 259, (n, 6)).astype(np.int32)
    mask = np.ones((n, 6), np.int32)
    mask[1, 4:] = 0
    mask[2, 2:] = 0
    enc = rng.standard_normal((n, 5, width)).astype(np.float32)
    jm = JQFormer(jcfg)
    args = tuple(jnp.asarray(a) for a in (query, ids, mask, enc))
    params = _perturb(jax.device_get(jm.init(jax.random.PRNGKey(0), *args)["params"]),
                      np.random.default_rng(5))
    ref = jm.apply({"params": params}, *args)
    tm = load_jax_params_(QFormer(_f32(tiny_model_config().qformer), width), params)
    out = tm(*(torch.from_numpy(a) for a in (query, ids, mask, enc)))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
