"""Decode GEMV with a fixed ascending-k f32 reduction per output.

``decode_gemv`` replaces the TPU kernel ``mraudio_tpu/ops/gemv.py::
decode_gemv`` (``_gemv_kernel``).  On CUDA tensors it launches
``csrc/decode_gemv.cu``: memory-bound (each weight byte is used by only
B <= 32 rows), one thread per output column walking k in order, weight
tiles streamed through a cp.async ring (see the source).  On CPU tensors
it runs :func:`decode_gemv_plain`, the same function.

Math per path, as ``LlamaLinear`` computes it:
  float — (x @ w) with f32 accumulation, rounded to the output dtype
  int8  — (x @ w_int8) with f32 accumulation, * scale in f32, rounded
"""

from __future__ import annotations

import ctypes

import torch

from mraudio_tpu_torch.ops import build

# x, w, scale, y, B, K, N, w_is_int8, block_n, block_k, stream
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _pick_block(dim: int, candidates=(512, 256, 128)) -> int:
    for c in candidates:
        if dim % c == 0:
            return c
    if dim <= 512 and dim % 8 == 0:
        return dim
    return 0


def supports(in_features: int, out_features: int) -> bool:
    """The even-tiling rule of the JAX kernel, kept as the routing rule
    (the padded 32008-wide lm_head does not tile and stays a plain
    matmul)."""
    return bool(_pick_block(in_features) and _pick_block(out_features))


def decode_gemv_plain(x, w, scale=None, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version: f32 product of the operands as given, then the
    per-column scale in f32, then rounding to ``out_dtype``.  (On the
    CPU the f32 matmul's own summation order applies.)"""
    acc = x.float() @ w.float()
    if scale is not None:
        acc = acc * scale.float()
    return acc.to(out_dtype)


def decode_gemv(x, w, scale=None, *, out_dtype=torch.bfloat16,
                block_n: int = 32, block_k: int = 128) -> torch.Tensor:
    """y = (x @ w) [* scale] for x (B, K), w (K, N) int8 or bf16, scale
    (N,) f32 for int8 weights.  ``block_n`` (threads and columns per
    block) and ``block_k`` (rows per pipeline stage) change the tiling,
    never the per-column reduction order."""
    if x.device.type == "cpu":
        return decode_gemv_plain(x, w, scale, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"decode_gemv: unsupported device {x.device}")
    b, kdim = x.shape
    k2, n = w.shape
    if k2 != kdim or b > 32:
        raise ValueError(f"decode_gemv: x {tuple(x.shape)} vs w {tuple(w.shape)} (B <= 32)")
    if x.dtype != torch.bfloat16 or out_dtype != torch.bfloat16:
        raise ValueError("decode_gemv kernel takes bf16 activations and output")
    if w.dtype == torch.int8:
        if scale is None or scale.dtype != torch.float32 or scale.shape != (n,):
            raise ValueError("decode_gemv: int8 weights need an (N,) f32 scale")
    elif w.dtype == torch.bfloat16:
        if scale is not None:
            raise ValueError("decode_gemv: bf16 weights take no scale")
    else:
        raise ValueError(f"decode_gemv: unsupported weight dtype {w.dtype}")
    if kdim % 8 or n % 8 or block_n % 32 or block_k % 8:
        raise ValueError("decode_gemv: K, N, block_k must be multiples of 8, block_n of 32")
    if not (x.is_contiguous() and w.is_contiguous()) or x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("decode_gemv: x and w must be contiguous and 16-byte aligned")
    for t in (w,) if scale is None else (w, scale):
        if t.device != x.device:
            raise ValueError("decode_gemv: operands on different devices")
    y = torch.empty((b, n), dtype=torch.bfloat16, device=x.device)
    fn = build.function("decode_gemv", "decode_gemv", _ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr() if scale is not None else None,
             y.data_ptr(), b, kdim, n, int(w.dtype == torch.int8), block_n, block_k,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "decode_gemv")
    decode_gemv.launches += 1
    return y


decode_gemv.launches = 0
