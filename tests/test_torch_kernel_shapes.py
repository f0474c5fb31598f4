"""CPU parity at the shapes the Hopper kernels tile.

The plain GEMV against the JAX Pallas kernel (interpret mode) at several
row counts and at a K of many reference tiles; the GEMV kernel's reduction
order, written out in PyTorch, against the same reference; and the plain
flash attention against the JAX Pallas kernel at head_dim 128 with S and
KV that are not multiples of the kernel's 128-row tiles."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from mraudio_tpu.ops.attention import flash_attention as j_flash
from mraudio_tpu.ops.gemv import _pick_block as j_pick_block
from mraudio_tpu.ops.gemv import decode_gemv as j_gemv
from mraudio_tpu_torch.ops.attention import flash_attention
from mraudio_tpu_torch.ops.gemv import (CLUSTERS, ROWS, all_launch_settings, decode_gemv,
                                        decode_gemv_in_order, launch_settings, reduction_order,
                                        segment_width)

torch.set_num_threads(1)

K_TILES, N = 1408, 256          # K = 11 reference tiles of 128


def _within_one_bf16_ulp(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert np.all(np.abs(out - ref) <= ulp), float(np.max(np.abs(out - ref) / ulp))


def _gemv_case(b, int8, seed=5):
    rng = np.random.default_rng(seed + b)
    x = rng.standard_normal((b, K_TILES)).astype(np.float32)
    if int8:
        w = rng.integers(-127, 128, (K_TILES, N)).astype(np.int8)
        scale = rng.uniform(0.001, 0.02, N).astype(np.float32)
    else:
        w = (rng.standard_normal((K_TILES, N)) * 0.05).astype(np.float32)
        scale = None
    jx = jnp.asarray(x, jnp.bfloat16)
    jw = jnp.asarray(w) if int8 else jnp.asarray(w, jnp.bfloat16)
    ref = j_gemv(jx, jw, None if scale is None else jnp.asarray(scale), interpret=True)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tw = torch.from_numpy(w) if int8 else torch.from_numpy(w).to(torch.bfloat16)
    ts = None if scale is None else torch.from_numpy(scale)
    return tx, tw, ts, np.asarray(jnp.asarray(ref, jnp.float32))


@pytest.mark.parametrize("b", [1, 2, 5, 8, 32])
def test_gemv_plain_matches_pallas_rows(b):
    tx, tw, ts, ref = _gemv_case(b, int8=True)
    before = decode_gemv.launches
    out = decode_gemv(tx, tw, ts)
    assert decode_gemv.launches == before
    assert out.shape == (b, N) and out.dtype == torch.bfloat16
    _within_one_bf16_ulp(out.float().numpy(), ref)


@pytest.mark.parametrize("b,int8", [(3, True), (3, False), (32, True)])
def test_gemv_kernel_order_matches_pallas(b, int8):
    """The kernel's documented order (11 segments of 128 rows here) is
    within one bf16 ulp of the reference's ascending-tile sum."""
    tx, tw, ts, ref = _gemv_case(b, int8)
    out = decode_gemv_in_order(tx, tw, ts)
    _within_one_bf16_ulp(out.float().numpy(), ref)


def test_gemv_in_order_is_sixteen_chains_per_segment():
    """A hand-built case: one segment of 32 rows, x = 1, so chain c sums
    w[c] + w[c + 16]; the tree and the segment sum are exact for these
    small integers."""
    w = torch.arange(32 * 8, dtype=torch.float32).reshape(32, 8).to(torch.bfloat16)
    x = torch.ones((1, 32), dtype=torch.bfloat16)
    assert segment_width(32) == 32
    out = decode_gemv_in_order(x, w)
    assert torch.equal(out, (x.float() @ w.float()).to(torch.bfloat16))


@pytest.mark.parametrize("k", [64, 200, 1408, 4096, 11008, 14336, 1000])
def test_segment_width_is_the_reference_tile(k):
    ref = j_pick_block(k)
    assert segment_width(k) == (ref or 128)
    nseg = -(-k // segment_width(k))
    assert reduction_order(k).startswith(f"K={k}: {nseg} segments of {segment_width(k)} rows")


@pytest.mark.parametrize("b,k,n,int8", [(3, 4096, 4096, True), (3, 4096, 11008, True),
                                        (3, 11008, 4096, True), (3, 4096, 4096, False),
                                        (1, 4096, 4096, True), (32, 4096, 4096, True),
                                        (5, 1408, 264, True)])
def test_gemv_default_launch_is_a_listed_setting(b, k, n, int8):
    cluster, rows = launch_settings(b, k, n, int8)
    assert (cluster, rows) in all_launch_settings()
    assert rows == min(b, 4)
    assert len(all_launch_settings()) == len(CLUSTERS) * len(ROWS)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas_d128_ragged(causal):
    rng = np.random.default_rng(11)
    b, h, s, kv, d = 2, 2, 200, 264, 128
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k = rng.standard_normal((b, h, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, h, kv, d)).astype(np.float32)
    mask = np.ones((b, kv), np.int32)
    mask[0, 0] = 0              # with causal, query row 0 of batch row 0 attends nothing
    mask[1, 130:150] = 0        # interior padding across the 128-key tile edge
    mask[:, s:] = 0             # cache tail not yet written
    ref = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
                  causal=causal, block_q=128, block_k=128, interpret=True)
    before = flash_attention.launches
    out = flash_attention(*(torch.from_numpy(a) for a in (q, k, v, mask)), causal=causal)
    assert flash_attention.launches == before
    if causal:
        assert np.all(out.numpy()[0, :, 0] == 0.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)
