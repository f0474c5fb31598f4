"""Port parity for ``ops/attention.py::chunked_attention`` against the JAX
package's XLA ``chunked_attention``, at small ``block_k``/``block_q`` so
that several tiles and ragged tails occur at tiny sizes.

Tolerances: f32 within 1e-5 abs and rel; bf16 (and int8 K/V with bf16
queries) per element within 2 bf16 ulps of |ref| plus 2^-6 of the rms of
ref's (b, h, query) row — the flash rule of ``chip_smoke.py``: both sides
round the output to bf16 and the probabilities to bf16 before p·v, in
other summation orders.  Fully masked rows must be exactly 0, and in the
port a prefill split into segments whose ``q_offset`` is a multiple of
``block_q`` must give the bits of the one-shot call."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from mraudio_tpu.ops.attention import chunked_attention as j_chunked
from mraudio_tpu_torch.ops.attention import chunked_attention

torch.set_num_threads(1)

BLOCK_K, BLOCK_Q = 16, 8
B, H, D = 2, 2, 16
F32_TOL = 1e-5
ULPS, ROW_REL = 2, 2.0 ** -6


def _inputs(s, kv, int8, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, s, H, D)).astype(np.float32)
    if int8:
        k = rng.integers(-127, 128, (B, kv, H, D)).astype(np.int8)
        v = rng.integers(-127, 128, (B, kv, H, D)).astype(np.int8)
    else:
        k = rng.standard_normal((B, kv, H, D)).astype(np.float32)
        v = rng.standard_normal((B, kv, H, D)).astype(np.float32)
    ks = rng.uniform(0.5, 1.5, (B, H, kv)).astype(np.float32) / 127.0
    vs = rng.uniform(0.5, 1.5, (B, H, kv)).astype(np.float32) / 127.0
    mask = np.ones((B, kv), np.int32)
    mask[1, 5:9] = 0                    # interior padding
    mask[0, 0] = 0                      # causal query 0 of row 0: nothing to attend
    return q, k, v, ks, vs, mask


def _bf16_ulp(x):
    mag = np.maximum(np.abs(x), 1e-30)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _check(out, ref, dtype):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=F32_TOL, atol=F32_TOL)
        return
    rms = np.sqrt(np.mean(ref ** 2, axis=-1, keepdims=True))
    limit = ULPS * _bf16_ulp(ref) + ROW_REL * rms
    assert np.all(np.abs(out - ref) <= limit), float(np.max(np.abs(out - ref) / limit))


def _run_port(q, k, v, ks, vs, mask, dtype, layout, int8, causal, q_offset=0, scales_bhs=True,
              block_q=BLOCK_Q):
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    tq = torch.from_numpy(q).to(tdt)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    if not int8:
        tk, tv = tk.to(tdt), tv.to(tdt)
    tks, tvs = torch.from_numpy(ks), torch.from_numpy(vs)
    if not scales_bhs:
        tks, tvs = tks.transpose(1, 2).contiguous(), tvs.transpose(1, 2).contiguous()
    if layout == "bhsd":
        tq, tk, tv = (t.transpose(1, 2).contiguous() for t in (tq, tk, tv))
    extra = dict(k_scale=tks, v_scale=tvs, scales_bhs=scales_bhs) if int8 else {}
    out = chunked_attention(tq, tk, tv, torch.from_numpy(mask), causal=causal,
                            block_k=BLOCK_K, block_q=block_q, kv_bshd=layout == "bshd",
                            q_bshd=layout == "bshd", q_offset=q_offset, **extra)
    if layout == "bhsd":
        out = out.transpose(1, 2)
    return out


def _run_jax(q, k, v, ks, vs, mask, dtype, layout, int8, causal, q_offset=0, scales_bhs=True,
             block_q=BLOCK_Q):
    jq = jnp.asarray(q, dtype)
    jk, jv = (jnp.asarray(a) if int8 else jnp.asarray(a, dtype) for a in (k, v))
    jks, jvs = jnp.asarray(ks), jnp.asarray(vs)
    if not scales_bhs:
        jks, jvs = jks.transpose(0, 2, 1), jvs.transpose(0, 2, 1)
    if layout == "bhsd":
        jq, jk, jv = (a.transpose(0, 2, 1, 3) for a in (jq, jk, jv))
    extra = dict(k_scale=jks, v_scale=jvs, scales_bhs=scales_bhs) if int8 else {}
    out = j_chunked(jq, jk, jv, jnp.asarray(mask), causal=causal, block_k=BLOCK_K,
                    block_q=block_q, kv_bshd=layout == "bshd", q_bshd=layout == "bshd",
                    q_offset=q_offset, **extra)
    if layout == "bhsd":
        out = out.transpose(0, 2, 1, 3)
    return np.asarray(out.astype(jnp.float32))


# (dtype, layout, int8 K/V, causal, S, KV, q_offset, scales (B, H, KV))
CASES = [
    ("float32", "bhsd", False, True, 37, 37, 0, True),     # KV not a multiple of block_k
    ("float32", "bhsd", False, False, 21, 48, 0, True),    # KV a multiple; causal off
    ("float32", "bshd", True, True, 40, 46, 0, True),      # int8, cache layout
    ("float32", "bshd", True, True, 13, 46, 24, True),     # a later prefill segment
    ("float32", "bshd", True, False, 1, 46, 0, True),      # s = 1 (a decode step)
    ("float32", "bshd", True, True, 29, 35, 0, False),     # scales in k's layout
    ("bfloat16", "bhsd", False, True, 37, 37, 0, True),
    ("bfloat16", "bshd", True, True, 40, 46, 0, True),
    ("bfloat16", "bshd", True, True, 16, 46, 16, True),
    ("bfloat16", "bshd", True, False, 21, 46, 0, True),    # int8, causal off
    ("float32", "bshd", True, True, 11, 46, 29, True),     # q_offset not a block multiple
]


@pytest.mark.parametrize("dtype,layout,int8,causal,s,kv,q_offset,scales_bhs", CASES,
                         ids=[f"{c[0]}-{c[1]}-{'int8' if c[2] else 'float'}-"
                              f"{'causal' if c[3] else 'full'}-s{c[4]}-kv{c[5]}-o{c[6]}"
                              f"{'' if c[7] else '-scales_bkh'}" for c in CASES])
def test_matches_jax(dtype, layout, int8, causal, s, kv, q_offset, scales_bhs):
    args = _inputs(s, kv, int8)
    kw = dict(dtype=dtype, layout=layout, int8=int8, causal=causal, q_offset=q_offset,
              scales_bhs=scales_bhs)
    out = _run_port(*args, **kw)
    ref = _run_jax(*args, **kw)
    assert out.shape == ref.shape
    _check(out.float().numpy(), ref, dtype)
    if causal and q_offset == 0:
        # query 0 of batch row 0 sees only a masked key: exactly 0
        assert bool((out[0, 0] == 0).all())


@pytest.mark.parametrize("dtype,int8,causal,s,q_offset", [
    ("float32", True, True, 40, 0), ("float32", False, False, 37, 0),
    ("float32", True, True, 21, 24), ("bfloat16", True, True, 40, 0)])
def test_chunk_loop_matches_jax(dtype, int8, causal, s, q_offset):
    """Tiles of more than 16 queries (block_q = 32) take the chunk loop;
    the cases above, at block_q = 8, take the one-pass route."""
    args = _inputs(s, 46, int8, seed=1)
    kw = dict(dtype=dtype, layout="bshd", int8=int8, causal=causal, q_offset=q_offset,
              block_q=32)
    _check(_run_port(*args, **kw).float().numpy(), _run_jax(*args, **kw), dtype)


def test_fully_masked_batch_row_is_exactly_zero():
    q, k, v, ks, vs, mask = _inputs(12, 30, True)
    mask[1] = 0
    for causal in (True, False):
        out = _run_port(q, k, v, ks, vs, mask, "bfloat16", "bshd", True, causal)
        assert bool((out[1] == 0).all())
        assert bool(torch.isfinite(out.float()).all())


@pytest.mark.parametrize("dtype,int8", [("float32", False), ("bfloat16", False),
                                        ("bfloat16", True)])
def test_segments_bit_identical_to_one_shot(dtype, int8):
    """Segments of 2·block_q rows (and a shorter last one) over the same
    cache, each with its q_offset, concatenate to the one-shot output."""
    s, kv = 53, 61
    q, k, v, ks, vs, mask = _inputs(s, kv, int8, seed=3)
    kw = dict(dtype=dtype, layout="bshd", int8=int8, causal=True)
    one = _run_port(q, k, v, ks, vs, mask, **kw)
    seg = 2 * BLOCK_Q
    parts = [_run_port(q[:, o:o + seg], k, v, ks, vs, mask, q_offset=o, **kw)
             for o in range(0, s, seg)]
    assert torch.equal(torch.cat(parts, dim=1), one)
