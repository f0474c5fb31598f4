"""Decode GEMV with a reduction order fixed by K alone.

``decode_gemv`` replaces the TPU kernel ``mraudio_tpu/ops/gemv.py::
decode_gemv`` (``_gemv_kernel``).  On CUDA tensors it launches
``csrc/decode_gemv.cu``: memory-bound (each weight byte is used by only
B <= 32 rows); clusters of CTAs split K into fixed segments, a producer
thread streams the weights by TMA through an mbarrier ring, and the
segment partials are added in ascending order through distributed shared
memory (see the source).  On CPU tensors it runs :func:`decode_gemv_plain`, the
same function.

The kernel's reduction order, a function of K alone: K is cut into
segments of :func:`segment_width` rows (the reference's ``_pick_block``);
inside a segment, 16 interleaved ascending-k f32 chains are added in a
balanced tree; the segment partials are added in ascending order; then
the scale, then rounding (:func:`decode_gemv_in_order` writes it out).
The launch settings (``cluster``, ``rows``) change no bit of the result.

Math per path, as ``LlamaLinear`` computes it:
  float — (x @ w) with f32 accumulation, rounded to the output dtype
  int8  — (x @ w_int8) with f32 accumulation, * scale in f32, rounded
"""

from __future__ import annotations

import ctypes
import itertools

import torch

from mraudio_tpu_torch.ops import build

# x, w, scale, y, B, K, N, row pitch of w, w_is_int8, cluster, rows, stream
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
# every launch setting the kernel takes (0 in the wrapper picks one)
CLUSTERS = (2, 4, 8, 16)
ROWS = (1, 2, 3, 4)
_TARGET_CTAS = 264      # two CTAs for each of the H100's 132 SMs


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


def segment_width(k: int) -> int:
    """Rows of K per segment of the kernel's reduction order: the
    reference's ``_pick_block(K)``, or 128 (with a shorter last segment)
    for a K it does not tile."""
    return _pick_block(k) or 128


def reduction_order(k: int) -> str:
    w = segment_width(k)
    nseg = -(-k // w)
    return (f"K={k}: {nseg} segments of {w} rows, each a 16-leaf tree of ascending-k "
            f"f32 chains; segments added in ascending order")


def launch_settings(b: int, k: int, n: int, int8: bool, cluster: int = 0,
                    rows: int = 0) -> tuple[int, int]:
    """(cluster, rows) for a launch; a 0 picks: all rows up to 4, and the
    smallest cluster that puts about two CTAs on each SM, doubling only
    while each CTA keeps at least one of K's segments (2 at the least)."""
    rows = rows or min(b, 4)
    strip = 128 if int8 else 64            # columns in 128 bytes of a row
    ctas = -(-n // strip) * -(-b // rows)
    nseg = -(-k // segment_width(k))
    if not cluster:
        cluster = CLUSTERS[0]
        while cluster < CLUSTERS[-1] and 2 * cluster <= nseg and ctas * cluster < _TARGET_CTAS:
            cluster *= 2
    return cluster, rows


def all_launch_settings():
    """Every (cluster, rows) the kernel takes."""
    return list(itertools.product(CLUSTERS, ROWS))


def decode_gemv_plain(x, w, scale=None, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version: f32 product of the operands as given, then the
    per-column scale in f32, then rounding to ``out_dtype``.  (The f32
    matmul's own summation order applies.)"""
    acc = x.float() @ w.float()
    if scale is not None:
        acc = acc * scale.float()
    return acc.to(out_dtype)


def decode_gemv_in_order(x, w, scale=None) -> torch.Tensor:
    """The kernel's reduction order written out in PyTorch, for checks
    (slow): per segment, 16 chains of f32 adds over k = s0 + c + 16 i
    (each product is exact in f32, so add-after-multiply is the kernel's
    fma), a balanced tree over the chains, then the segments in ascending
    order, the scale and bf16 rounding.  Bit-identical to the kernel."""
    b, k = x.shape
    width = segment_width(k)
    xf, wf = x.float(), w.float()
    total = torch.zeros((b, w.shape[1]), dtype=torch.float32, device=x.device)
    for s0 in range(0, k, width):
        s1 = min(s0 + width, k)
        chains = torch.zeros((16, b, w.shape[1]), dtype=torch.float32, device=x.device)
        for k0 in range(s0, s1, 16):
            n = min(16, s1 - k0)       # rows past the segment's end add nothing
            chains[:n] = chains[:n] + xf[:, k0:k0 + n].t()[:, :, None] * wf[k0:k0 + n, None, :]
        while chains.shape[0] > 1:
            chains = chains[0::2] + chains[1::2]
        total = total + chains[0]
    if scale is not None:
        total = total * scale.float()
    return total.to(torch.bfloat16)


def decode_gemv(x, w, scale=None, *, out_dtype=torch.bfloat16,
                cluster: int = 0, rows: int = 0) -> torch.Tensor:
    """y = (x @ w) [* scale] for x (B, K), w (K, N) int8 or bf16, scale
    (N,) f32 for int8 weights.  ``cluster`` (CTAs splitting K's segments:
    2, 4, 8 or 16) and ``rows`` (batch rows per CTA, 1-4) change the launch,
    never the result; 0 picks."""
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
    if kdim % 8 or n % 8:
        raise ValueError("decode_gemv: K and N must be multiples of 8")
    if not (x.is_contiguous() and w.is_contiguous()) or x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("decode_gemv: x and w must be contiguous and 16-byte aligned")
    for t in (w,) if scale is None else (w, scale):
        if t.device != x.device:
            raise ValueError("decode_gemv: operands on different devices")
    int8 = w.dtype == torch.int8
    cluster, rows = launch_settings(b, kdim, n, int8, cluster, rows)
    if cluster not in CLUSTERS or rows not in ROWS:
        raise ValueError(f"decode_gemv: cluster {cluster}, rows {rows}")
    if int8 and n % 16:
        # TMA rows must start 16 bytes apart: pad the rows (small shapes only)
        w = torch.nn.functional.pad(w, (0, 16 - n % 16))
    y = torch.empty((b, n), dtype=torch.bfloat16, device=x.device)
    fn = build.function("decode_gemv", "decode_gemv", _ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr() if scale is not None else None,
             y.data_ptr(), b, kdim, n, w.shape[1], int(int8), cluster, rows,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "decode_gemv")
    decode_gemv.launches += 1
    return y


decode_gemv.launches = 0
