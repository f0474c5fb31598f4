"""Port parity for the two kernel modules on the CPU: each wrapper, given
CPU tensors, runs its plain version (and launches nothing); that plain
version is held against the JAX package's Pallas kernel in interpret
mode.  Also the plain int8 decode attention against the JAX decode
route (``chunked_attention`` with its flags)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from mraudio_tpu.models.llama import quantize_kv as j_quantize_kv
from mraudio_tpu.ops.attention import chunked_attention as j_chunked
from mraudio_tpu.ops.attention import flash_attention as j_flash
from mraudio_tpu.ops.gemv import decode_gemv as j_gemv
from mraudio_tpu.ops.gemv import supports as j_supports
from mraudio_tpu_torch.models.llama import quantize_kv
from mraudio_tpu_torch.ops.attention import chunked_attention, flash_attention
from mraudio_tpu_torch.ops.gemv import decode_gemv, supports

torch.set_num_threads(1)


def _bf16_np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _within_one_bf16_ulp(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    # bf16 ulp at |ref|: 2^(floor(log2|ref|) - 7); subnormal-safe floor
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert np.all(np.abs(out - ref) <= ulp), float(np.max(np.abs(out - ref) / ulp))


# ---------------------------------------------------------------- flash (A)

@pytest.mark.parametrize("s,kv_extra,block,causal", [
    (200, 0, 128, True),      # S not a multiple of the block
    (64, 0, 32, True),
    (96, 40, 32, True),       # kv_len > S (a longer, partly unwritten cache)
    (128, 0, 64, False),      # non-causal
])
def test_flash_plain_matches_pallas_interpret(s, kv_extra, block, causal):
    rng = np.random.default_rng(0)
    b, h, d = 2, 3, 32
    kv = s + kv_extra
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k = rng.standard_normal((b, h, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, h, kv, d)).astype(np.float32)
    mask = np.ones((b, kv), np.int32)
    mask[0, 10:20] = 0          # interior padding (timestamp slots)
    mask[1, :7] = 0             # left padding
    mask[:, s:] = 0             # cache tail not yet written
    ref = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
                  causal=causal, block_q=block, block_k=block, interpret=True)
    before = flash_attention.launches
    out = flash_attention(*(torch.from_numpy(a) for a in (q, k, v, mask)), causal=causal)
    assert flash_attention.launches == before == 0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_flash_plain_fully_masked_row_is_exact_zero():
    rng = np.random.default_rng(3)
    b, h, s, d = 1, 2, 64, 32
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, s), np.int32)
    mask[0, 0] = 0  # query row 0 attends nothing under causal + invalid
    ref = j_flash(*(jnp.asarray(a) for a in (q, k, v, mask)), causal=True,
                  block_q=32, block_k=32, interpret=True)
    out = flash_attention(*(torch.from_numpy(a) for a in (q, k, v, mask)), causal=True).numpy()
    assert np.all(out[0, :, 0] == 0.0)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_flash_plain_bf16_io():
    rng = np.random.default_rng(2)
    b, h, s, d = 1, 2, 128, 64
    arrs = [rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3)]
    mask = np.ones((b, s), np.int32)
    ref = j_flash(*(jnp.asarray(a, jnp.bfloat16) for a in arrs), jnp.asarray(mask),
                  interpret=True)
    out = flash_attention(*(torch.from_numpy(a).to(torch.bfloat16) for a in arrs),
                          torch.from_numpy(mask))
    assert out.dtype == torch.bfloat16
    # both compute in f32 from the same bf16 inputs; outputs round to bf16
    _within_one_bf16_ulp(out.float().numpy(), _bf16_np(ref))


# ----------------------------------------------------------------- GEMV (B)

def test_supports_production_dims():
    for kdim, n in ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32008), (64, 192),
                    (64, 260)):
        assert supports(kdim, n) == j_supports(kdim, n)
    assert not supports(4096, 32008)


@pytest.mark.parametrize("int8", [True, False])
def test_gemv_plain_matches_pallas_interpret(int8):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 1024)).astype(np.float32)
    if int8:
        w = rng.integers(-127, 128, (1024, 768)).astype(np.int8)
        scale = rng.uniform(0.001, 0.02, 768).astype(np.float32)
    else:
        w = rng.standard_normal((1024, 768)).astype(np.float32)
        scale = None
    jx = jnp.asarray(x, jnp.bfloat16)
    jw = jnp.asarray(w) if int8 else jnp.asarray(w, jnp.bfloat16)
    ref = j_gemv(jx, jw, None if scale is None else jnp.asarray(scale), interpret=True)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tw = torch.from_numpy(w) if int8 else torch.from_numpy(w).to(torch.bfloat16)
    before = decode_gemv.launches
    out = decode_gemv(tx, tw, None if scale is None else torch.from_numpy(scale))
    assert decode_gemv.launches == before == 0
    assert out.dtype == torch.bfloat16 and out.shape == (3, 768)
    # the f32 sums are taken in another order: at most one bf16 ulp apart
    _within_one_bf16_ulp(out.float().numpy(), _bf16_np(ref))


# ------------------------------------------------------- decode attention

def test_decode_attention_matches_chunked_decode_route():
    rng = np.random.default_rng(4)
    b, kv, h, d = 2, 700, 3, 32   # > block_k=512: a full chunk plus the ragged tail
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.standard_normal((b, kv, h, d)).astype(np.float32)
    v = rng.standard_normal((b, kv, h, d)).astype(np.float32)
    mask = np.ones((b, kv), np.int32)
    mask[0, 100:140] = 0
    mask[1, 650:] = 0
    kq, ks = j_quantize_kv(jnp.asarray(k))
    vq, vs = j_quantize_kv(jnp.asarray(v))
    ks_bhs, vs_bhs = ks.transpose(0, 2, 1), vs.transpose(0, 2, 1)   # cache layout
    ref = j_chunked(jnp.asarray(q), kq, vq, jnp.asarray(mask), causal=False, unroll_q=True,
                    k_scale=ks_bhs, v_scale=vs_bhs, kv_bshd=True, q_bshd=True,
                    scales_bhs=True)
    tkq, tks = quantize_kv(torch.from_numpy(k))
    tvq, tvs = quantize_kv(torch.from_numpy(v))
    np.testing.assert_array_equal(tkq.numpy(), np.asarray(kq))
    np.testing.assert_array_equal(tks.numpy(), np.asarray(ks))
    # the port's one-token decode step: chunked_attention with the query
    # at the last cache column (causal, so every column is visible)
    out = chunked_attention(torch.from_numpy(q), tkq, tvq, torch.from_numpy(mask), causal=True,
                            q_offset=kv - 1, k_scale=tks.transpose(1, 2),
                            v_scale=tvs.transpose(1, 2), kv_bshd=True, q_bshd=True,
                            scales_bhs=True)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
