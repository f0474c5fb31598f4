"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--out results.json] [--only kernels,models,evaluate,serve]

Phases, each printing one JSON line with its seconds:

1. the card: ``torch.cuda.is_available()`` (exit 1 without a card) and
   its ``nvidia-smi`` name and power limit;
2. build: both CUDA kernels from ``mraudio_tpu_torch/csrc`` with nvcc for
   sm_90a, in parallel;
3. kernels: each kernel's wrapper at the main path's shapes, held against
   its plain PyTorch version on the same inputs, and timed beside its
   bound and one PyTorch library call computing the same function (the
   GEMV and its yardsticks by CUDA-graph replay, i.e. device time).  Flash
   also runs three smaller cases (head_dim 64, causal off, ragged S and KV)
   with exact zeros for fully masked rows; the GEMV must give the same bits
   under every launch setting, at B = 1, 8 and 32 and at two small odd
   shapes too, and the bits of its documented reduction order
   (``decode_gemv_in_order``); at M = 12 rows (a speculative pass: 3
   rows x 4 positions) it is timed too, and each row must give the bits
   of the same row in an M = 3 launch; at M = 4 and 16 (the serving
   engine's 4 slots, greedy and in a verify pass of 4 positions) it is
   timed too, and the rows of an M = 16 launch must give the bits of
   M = 4 launches.  Plain ops (no kernel: XLA in the
   reference) timed at their shapes: ``chunked_attention`` one-shot and
   as three prefill segments, whose output must be bit-identical, held
   against flash; its per-row route (``q_abs``: 3 rows of 4 queries at
   ragged columns, and the one-token decode step), held against a dense
   f32 computation and, with every row at one column, bit-identical to
   the ``q_offset`` route; and the default configuration's int8 decode
   projections (``decode_gemv="xla"``), whose rows must keep their bits
   at 4x the rows;
4. small reference: a narrow slice model (head_dim 128) generates on the
   card and on the CPU (plain versions) from the same weights; the
   prefill logits must agree, one-shot, in three 512-token prefill
   segments of a 32-frame batch, and under the ``--fast`` preset
   (temporal-residual ViT, yuv420 wire, grammar decoding at
   ``spec_width=4``), whose texts must parse;
5. full-width generate: X-InstructBLIP (EVA-ViT-g, BEATs, two Q-Formers,
   int8 Vicuna-7B with int8 KV cache) on 3 synthetic QVHighlights clips
   (60 frames of 224² RGB, 152 s of 16 kHz audio), random weights from a
   seed, in the slice configuration (both kernels, one-shot prefill);
   launch counts are read around this run and asserted;
6. profile: one more generate under ``torch.profiler``: each phase's
   (encode, prefill, decode) device time per kernel and idle share;
7. segmented prefill: the same model and batch with ``prefill_chunk=2048``
   (3 segments: flash on the first, ``chunked_attention`` on the others);
   launch counts asserted, logits compared with the one-shot run; then
   ``attention_impl="chunked"`` one-shot and segmented (0 flash launches),
   which part flash-vs-chunked from the projections' row count;
8. grammar generate: the same model and batch with grammar-constrained
   decoding at ``spec_width`` 4 and 1: launch counts asserted (32 flash,
   7 x 32 GEMV per pass), every text parses to windows, and the tokens of
   the two widths must be identical; then the pair again with the default
   configuration's plain projections (``decode_gemv="xla"``);
9. lookup generate: ``lookup_spec=4``; its tokens must be greedy's (5);
10. evaluate: the model freed, the evaluate CLI in-process at full width
    in the deployed default configuration (chunked attention, XLA-route
    projections, no kernel: 0 launches asserted) on 5 synthetic QVH clips
    at batch 3, its JSONL checked and scored with the port's scorer; then
    its first batch once more under ``--profile-dir``, broken down as in 6;
11. fast evaluate: the same with ``--fast`` (the yuv420 wire, the
    temporal-residual ViT, grammar decoding): 0 kernel launches and 0
    invalid predictions asserted;
12. serve: the serve CLI in-process at full width in its default
    configuration (4 slots, 1 step per dispatch, pipeline depth 2,
    upfront encode) on 6 synthetic QVH requests, so that two slots are
    reused: 6 records on the serve schema, 0 kernel launches, the stats
    line and the peak memory;
13. serve identities: 3 requests of the same model in-process; each
    request's engine tokens must equal the offline ``greedy_generate`` at
    batch 3, at pipeline depth 2 and 1, 2 steps per dispatch,
    ``spec_width`` 4 with hints and with a fourth request cancelled mid-
    decode; ``serve()`` must report its timeouts, and Poisson arrivals
    must give the burst run's records; the depth-2 run is traced (device
    idle share of the ``engine`` span);
14. serve deployed: ``bench.py``'s serve profile through the CLI (4 slots,
    ``--max-prefill-batch 2``, ``--kv-keep 1784``, 2 steps per dispatch,
    inline encode in groups of 2 with one group prepared ahead) on 6
    requests; then, for one admission, every layer's kept columns must be
    the plain rule's selection from the card's own ``obs_score``, which
    must lie within its limit of a dense f32 computation, and ``kv_keep``
    above the prefix length must give the uncompacted tokens;
15. serve slice: the engine in the slice configuration, greedy and at
    ``spec_width`` 4: 32 flash launches per admission, 224 GEMV launches
    per dispatch, identical tokens.

``--only`` runs the named groups of phases (kernels: 3; models: 4-9;
evaluate: 10-11; serve: 12-15) after the build, for debugging; such a
run prints no summary and no ``ok`` line.

The last three lines are the card's ``nvidia-smi`` name and power limit,
the per-kernel summary ``{"kernels": [...]}``, and
``{"ok": true, "device": {...}}``.  Any failed check raises: the run then
exits non-zero and prints no ``ok`` line.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM datasheet peaks (dense): the bound column of the kernel table.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_TENSOR_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12           # CUDA-core f32 FMA rate (the GEMV's arithmetic)
# flash vs plain, per element: |out - ref| <= 2 bf16 ulps of |ref| (both
# are rounded to bf16) + 2^-6 of the rms of ref's (b, h, query) row (the
# kernel rounds the probabilities to bf16 before p·v, the plain version
# keeps them in f32: a relative error of about 2^-9 per term).
FLASH_ULPS = 2
FLASH_ROW_REL = 2.0 ** -6
SMALL_LOGIT_ATOL = 3e-2                  # bf16 model, card vs CPU rounding
# GEMV vs plain: 1 bf16 ulp + GEMV_SUM_ERR * sqrt(K) * 2^-24 * sum|x w| (the
# size of an f32 summation error; see gemv_identity)
GEMV_SUM_ERR = 4.0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call over ``iters`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Device milliseconds per call: ``calls`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events.  For kernels
    shorter than the wrapper's host cost this is the time the decode loop
    sees, where the host runs ahead of the device; a host-timed loop would
    measure the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# Phase 3: kernels at main-path shapes
# --------------------------------------------------------------------------


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    mag = x.float().abs().clamp_min(1e-30)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def flash_excess(out: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest |out - ref| over its limit (FLASH_ULPS, FLASH_ROW_REL);
    the check passes at <= 1."""
    r = ref.float()
    limit = FLASH_ULPS * _bf16_ulp(r) + FLASH_ROW_REL * r.square().mean(-1, keepdim=True).sqrt()
    return float(((out.float() - r).abs() / limit).max())


def flash_case(dev, b, h, s, kv, d, causal, gen, zero_rows):
    """Untimed: one smaller case against the plain version under the same
    per-element limit; ``zero_rows`` (b, query) must come out exactly 0."""
    from mraudio_tpu_torch.ops.attention import flash_attention, flash_attention_plain

    q = torch.randn((b, s, h, d), generator=gen, device=dev).to(torch.bfloat16).transpose(1, 2)
    k = torch.randn((b, kv, h, d), generator=gen, device=dev).to(torch.bfloat16).transpose(1, 2)
    v = torch.randn((b, kv, h, d), generator=gen, device=dev).to(torch.bfloat16).transpose(1, 2)
    mask = torch.ones((b, kv), dtype=torch.int32, device=dev)
    mask[:, s:] = 0
    mask[0, 0] = 0
    mask[b - 1, 60:75] = 0
    if not causal:
        mask[b - 1] = 0             # a batch row with nothing to attend
    out = flash_attention(q, k, v, mask, causal=causal)
    ref = flash_attention_plain(q, k, v, mask, causal=causal)
    torch.cuda.synchronize()
    excess = flash_excess(out, ref)
    what = f"flash_attention d={d} s={s} kv={kv} causal={causal}"
    if not excess <= 1.0:
        raise AssertionError(f"{what}: {excess} x its limit")
    for bi, qi in zero_rows:
        if not bool((out[bi, :, qi] == 0).all()):
            raise AssertionError(f"{what}: fully masked row ({bi}, {qi}) is not exactly 0")
    return dict(shape=dict(b=b, h=h, s=s, kv=kv, d=d, causal=causal), err_over_limit=excess,
                max_abs_err=float((out.float() - ref.float()).abs().max()))


def check_flash_cases(dev, gen) -> list:
    """D = 64; the causal flag off; S and KV that are not multiples of the
    kernel's 128-row tiles, with KV > S."""
    return [flash_case(dev, 2, 4, 384, 384, 64, True, gen, [(0, 0)]),
            flash_case(dev, 2, 4, 300, 300, 128, False, gen, [(1, q) for q in range(300)]),
            flash_case(dev, 2, 4, 777, 1000, 128, True, gen, [(0, 0)])]


def check_flash(dev, b, h, s, kv, d, gen):
    from mraudio_tpu_torch.ops.attention import flash_attention, flash_attention_plain

    # the prefill's layout: (B, S, H, D) buffers read through transposed views
    q = torch.randn((b, s, h, d), generator=gen, device=dev).to(torch.bfloat16).transpose(1, 2)
    k = torch.randn((b, kv, h, d), generator=gen, device=dev).to(torch.bfloat16).transpose(1, 2)
    v = torch.randn((b, kv, h, d), generator=gen, device=dev).to(torch.bfloat16).transpose(1, 2)
    mask = torch.ones((b, kv), dtype=torch.int32, device=dev)
    mask[:, s:] = 0                 # cache columns the prefill has not written
    mask[0, 0] = 0                  # query row 0 of batch row 0: fully masked
    mask[1, 1000:1040] = 0          # interior padding (timestamp slots)
    mask[2, :17] = 0                # left padding
    out = flash_attention(q, k, v, mask, causal=True)
    ref = flash_attention_plain(q, k, v, mask, causal=True)
    torch.cuda.synchronize()
    max_err = float((out.float() - ref.float()).abs().max())
    excess = flash_excess(out, ref)
    if not excess <= 1.0:
        raise AssertionError(f"flash_attention disagrees with its plain version: "
                             f"max |err| {max_err}, {excess} x its limit")
    if not bool((out[0, :, 0] == 0).all()):
        raise AssertionError("flash_attention: fully masked row is not exactly 0")
    if not bool(torch.isfinite(out.float()).all()):
        raise AssertionError("flash_attention: non-finite output")
    # controls: the output of a kernel that ignored the interior padding,
    # or skipped one kv tile, must fail the same check
    controls = {}
    for name, cols, value in (("interior_padding_ignored", (1, slice(1000, 1040)), 1),
                              ("kv_tile_skipped", (2, slice(2944, 3072)), 0)):
        bad_mask = mask.clone()
        bad_mask[cols] = value
        controls[name] = flash_excess(flash_attention(q, k, v, bad_mask, causal=True), ref)
        if not controls[name] > 1.0:
            raise AssertionError(f"flash check cannot tell {name}: {controls[name]} x its limit")

    ms = cuda_ms(lambda: flash_attention(q, k, v, mask, causal=True), iters=10)
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, mask, causal=True), iters=2)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    causal = torch.ones((s, kv), dtype=torch.bool, device=dev).tril()
    attn_mask = (causal[None] & mask[:, None, :].bool())[:, None]      # (B, 1, S, KV)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(lambda: sdpa(qc, kc, vc, attn_mask=attn_mask), iters=5)

    # the work these inputs need: (query, key) pairs that are attended
    valid_pairs = 0
    for bi in range(b):
        prefix_valid = torch.cumsum(mask[bi].long(), 0)               # valid keys <= column
        valid_pairs += int(prefix_valid[:s].sum())
    flops = 4.0 * h * d * valid_pairs
    nbytes = 2.0 * (2 * b * h * s * d + 2 * b * h * kv * d) + 4.0 * b * kv
    bms, by = bound_ms(nbytes, flops, PEAK_BF16_TENSOR_FLOPS)
    return dict(name="flash_attention", max_abs_err=max_err, err_over_limit=excess,
                controls_err_over_limit=controls, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bms, bound_by=by,
                shape=dict(b=b, h=h, s=s, kv=kv, d=d), flops=flops, bytes=nbytes)


def _gemv_inputs(b, kdim, n, int8, gen, copies=1):
    x = torch.randn((b, kdim), generator=gen, device="cuda").to(torch.bfloat16)
    if int8:
        ws = [torch.randint(-127, 128, (kdim, n), generator=gen, device="cuda", dtype=torch.int8)
              for _ in range(copies)]
        scale = torch.rand((n,), generator=gen, device="cuda") * (0.02 / 73.6) + 1e-4
    else:
        ws = [(torch.randn((kdim, n), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
              for _ in range(copies)]
        scale = None
    return x, ws, scale


def gemv_identity(x, w, scale, what: str) -> float:
    """The kernel under every launch setting its wrapper takes, and twice
    under the default, must give the same bits, and the bits of its
    documented reduction order written out in PyTorch; the result must lie
    within 1 bf16 ulp of the plain version plus the f32 summation error.
    Returns the error against plain: max |err|, the largest |err| / limit
    and the count of outputs more than 1 ulp away."""
    from mraudio_tpu_torch.ops.gemv import (all_launch_settings, decode_gemv,
                                            decode_gemv_in_order, decode_gemv_plain)

    y = decode_gemv(x, w, scale)
    y2 = decode_gemv(x, w, scale)
    ref = decode_gemv_plain(x, w, scale)
    torch.cuda.synchronize()
    if not torch.equal(y, y2):
        raise AssertionError(f"decode_gemv {what}: two launches differ")
    if not torch.equal(y, decode_gemv_in_order(x, w, scale)):
        raise AssertionError(f"decode_gemv {what}: not the documented reduction order")
    for cluster, rows in all_launch_settings():
        yi = decode_gemv(x, w, scale, cluster=cluster, rows=rows)
        if not torch.equal(y, yi):
            raise AssertionError(f"decode_gemv {what}: cluster={cluster} rows={rows} "
                                 "differs from the default launch")
    err = (y.float() - ref.float()).abs()
    # Two f32 sums of the same exact products, taken in different orders,
    # differ by about sqrt(K) * 2^-24 * sum|x w|.  Where an output nearly
    # cancels, that is more than 1 bf16 ulp of it, whatever the order (on
    # random data about 1 output in 10^5, for a single ascending chain as
    # for the segment order), so the limit is 1 ulp plus that much.
    mag = x.float().abs() @ w.float().abs()
    if scale is not None:
        mag = mag * scale.float()
    limit = _bf16_ulp(ref) + GEMV_SUM_ERR * math.sqrt(x.shape[1]) * 2.0 ** -24 * mag
    if not bool((err <= limit).all()):
        raise AssertionError(f"decode_gemv {what}: {float((err / limit).max())} x its limit "
                             "from plain")
    return dict(max_abs_err=float(err.max()), err_over_limit=float((err / limit).max()),
                over_one_ulp=int((err > _bf16_ulp(ref)).sum()))


def check_gemv(dev, b, kdim, n, int8, gen, cold_bytes=160e6, by_cluster: bool = True):
    from mraudio_tpu_torch.ops.gemv import (CLUSTERS, all_launch_settings, decode_gemv,
                                            decode_gemv_plain, launch_settings, reduction_order)

    wbytes = kdim * n * (1 if int8 else 2)
    copies = max(1, int(np.ceil(cold_bytes / wbytes)))   # rotate past the 50 MB L2
    x, ws, scale = _gemv_inputs(b, kdim, n, int8, gen, copies)
    vs_plain = gemv_identity(x, ws[0], scale, f"{kdim}x{n}")

    it = [0]

    def run(fn):
        def call():
            it[0] = (it[0] + 1) % copies
            return fn(ws[it[0]])
        return call

    ms = graph_ms(run(lambda wi: decode_gemv(x, wi, scale)))
    cluster0, rows0 = launch_settings(b, kdim, n, int8)
    cluster_ms = {c: graph_ms(run(lambda wi, c=c: decode_gemv(x, wi, scale, cluster=c, rows=rows0)))
                  for c in CLUSTERS} if by_cluster else None
    plain_ms = graph_ms(run(lambda wi: decode_gemv_plain(x, wi, scale)), calls=5)
    if int8:   # the library call reads pre-dequantized bf16 weights: 2x the bytes
        deq = [(wi.float() * scale).to(torch.bfloat16) for wi in ws[:max(1, copies // 2)]]
    else:
        deq = ws
    lib_it = [0]

    def lib():
        lib_it[0] = (lib_it[0] + 1) % len(deq)
        return torch.mm(x, deq[lib_it[0]])

    library_ms = graph_ms(lib)
    nbytes = wbytes + 2.0 * b * kdim + 2.0 * b * n + (4.0 * n if int8 else 0.0)
    flops = 2.0 * b * kdim * n
    bms, by = bound_ms(nbytes, flops, PEAK_F32_FLOPS)
    return dict(name=f"decode_gemv {'int8' if int8 else 'bf16'} {kdim}x{n}", b=b,
                **vs_plain, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                library_note="torch.mm on pre-dequantized bf16 weights" if int8 else "torch.mm",
                bound_ms=bms, bound_by=by, bytes=nbytes, order=reduction_order(kdim),
                launch=(cluster0, rows0), ms_by_cluster=cluster_ms,
                settings_equal=len(all_launch_settings()))


def check_gemv_other(gen) -> dict:
    """Untimed: the same checks at other row counts (a speculative verify
    pass sends B x W rows) and at small shapes off the main path: an int8
    N that is not a multiple of 16 (the wrapper pads the rows), ragged
    column strips, a K of 11 segments and a K of one short segment."""
    out = {}
    for b, kdim, n, int8 in ((1, 4096, 4096, True), (8, 4096, 4096, True),
                             (32, 4096, 4096, True), (5, 1408, 264, True),
                             (2, 200, 200, False)):
        x, ws, scale = _gemv_inputs(b, kdim, n, int8, gen)
        what = f"B={b} {kdim}x{n} {'int8' if int8 else 'bf16'}"
        out[what] = gemv_identity(x, ws[0], scale, what)
    return out


def check_gemv_rows(gen, m: int = 12, split: int = 3) -> dict:
    """At the three int8 shapes, the GEMV at ``m`` rows (a speculative
    pass: 3 rows x 4 positions) gives each row the bits it has in an
    M = ``split`` launch: rows are independent and the order is K's."""
    from mraudio_tpu_torch.ops.gemv import decode_gemv

    out = {}
    for kdim, n in ((4096, 4096), (4096, 11008), (11008, 4096)):
        x, ws, scale = _gemv_inputs(m, kdim, n, True, gen)
        y = decode_gemv(x, ws[0], scale)
        for r0 in range(0, m, split):
            part = decode_gemv(x[r0:r0 + split].contiguous(), ws[0], scale)
            if not torch.equal(y[r0:r0 + split], part):
                raise AssertionError(f"decode_gemv {kdim}x{n}: rows {r0}..{r0 + split - 1} of an "
                                     f"M={m} launch differ from an M={split} launch")
        out[f"{kdim}x{n}"] = f"M={m} rows bit-identical to M={split} launches"
    return out


def _dense_attention(q, kq, vq, ks, vs, mask, q_abs):
    """The function ``chunked_attention`` computes, in f32 over the whole
    cache at once: q (B, W, H, D), int8 k/v (B, KV, H, D), scales
    (B, H, KV); per-row causal at ``q_abs`` (B, W).  Returns (B, H, W, D)."""
    d = q.shape[-1]
    logits = torch.einsum("bwhd,bkhd->bhwk", q.float(), kq.float()) * (1.0 / math.sqrt(d))
    logits = logits * ks[:, :, None, :]
    cols = torch.arange(kq.shape[1], device=q.device)
    valid = mask[:, None, None, :].bool() & (cols <= q_abs[:, None, :, None])
    m = torch.where(valid, logits, -1e30).amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(logits - m), 0.0)
    out = torch.einsum("bhwk,bkhd->bhwd", p * vs[:, :, None, :], vq.float())
    return out / p.sum(-1, keepdim=True)


def check_per_row_attention(dev, b, h, s, w, d, gen):
    """Plain ``chunked_attention``'s per-row route (``q_abs``; no kernel:
    XLA in the reference) at the decode passes' shapes over the int8
    cache of an ``s``-token prefix (``s + 64 + 16`` columns, as every
    decoder allocates): ``b`` rows of ``w`` queries at ragged columns (a
    speculative pass), then of 1 (a greedy step).  Each is held against a
    dense f32 computation of the same function under the flash rule, must
    give, with every row at one column, the bits of the ``q_offset``
    route, and is timed (one layer)."""
    from mraudio_tpu_torch.infer.generate import MAX_SPEC_WIDTH
    from mraudio_tpu_torch.models.llama import quantize_kv
    from mraudio_tpu_torch.ops.attention import chunked_attention

    kv = s + 64 + MAX_SPEC_WIDTH
    kq, ks = quantize_kv(torch.randn((b, kv, h, d), generator=gen, device=dev))
    vq, vs = quantize_kv(torch.randn((b, kv, h, d), generator=gen, device=dev))
    ks, vs = ks.transpose(1, 2).contiguous(), vs.transpose(1, 2).contiguous()
    kw = dict(causal=True, k_scale=ks, v_scale=vs, scales_bhs=True, kv_bshd=True, q_bshd=True)
    cols = torch.arange(kv, device=dev)
    starts = torch.tensor([s + 10, s + 33, s + 57][:b], device=dev)
    out = {}
    for width in (w, 1):
        q = torch.randn((b, width, h, d), generator=gen, device=dev).to(torch.bfloat16)
        q_abs = starts[:, None] + torch.arange(width, device=dev)[None]
        mask = (cols[None] <= q_abs[:, -1:]).to(torch.int32)
        mask[1, 1000:1040] = 0          # interior padding (timestamp slots)
        mask[2, :17] = 0                # left padding
        got = chunked_attention(q, kq, vq, mask, q_abs=q_abs, **kw)
        ref = _dense_attention(q, kq, vq, ks, vs, mask, q_abs)
        excess = flash_excess(got.transpose(1, 2), ref)
        max_err = float((got.transpose(1, 2).float() - ref).abs().max())
        if not excess <= 1.0 or not bool(torch.isfinite(got.float()).all()):
            raise AssertionError(f"chunked_attention q_abs W={width}: max |err| {max_err}, "
                                 f"{excess} x the flash rule against dense f32")
        col = s + 33
        shared = (col + torch.arange(width, device=dev))[None].expand(b, width)
        smask = (cols[None] <= col + width - 1).to(torch.int32).expand(b, kv)
        at_shared = chunked_attention(q, kq, vq, smask, q_abs=shared, **kw)
        if not torch.equal(at_shared, chunked_attention(q, kq, vq, smask, q_offset=col, **kw)):
            raise AssertionError(f"chunked_attention W={width}: q_abs at one column differs "
                                 "from the q_offset route")
        # a query keeps its bits alone in its pass, as a greedy step
        for j in range(width):
            jmask = (cols[None] <= col + j).to(torch.int32).expand(b, kv)
            alone = chunked_attention(q[:, j:j + 1], kq, vq, jmask, q_offset=col + j, **kw)
            if not torch.equal(at_shared[:, j:j + 1], alone):
                raise AssertionError(f"chunked_attention W={width}: query {j} differs from the "
                                     "same query alone")
        ms = cuda_ms(lambda: chunked_attention(q, kq, vq, mask, q_abs=q_abs, **kw), iters=20)
        valid_pairs = int(((cols[None, None] <= q_abs[:, :, None]) & mask[:, None].bool()).sum())
        flops = 4.0 * h * d * valid_pairs
        nbytes = 2.0 * b * kv * h * d + 2 * 4.0 * b * h * kv + 4.0 * b * kv + 2 * 2.0 * b * width * h * d
        bms, by = bound_ms(nbytes, flops, PEAK_BF16_TENSOR_FLOPS)
        out[f"w{width}"] = dict(ms=ms, bound_ms=bms, bound_by=by, max_abs_err_vs_dense=max_err,
                                err_over_limit=excess, shared_column_equals_q_offset=True)
    return dict(name="chunked_attention per-row route (plain, int8 KV, q_abs)",
                shape=dict(b=b, h=h, kv=kv, d=d, w=w), per="one layer, one pass", **out)


def check_xla_projections(dev, b, gen, cold_bytes=160e6) -> dict:
    """The default configuration's decode projections (``decode_gemv="xla"``:
    ``LlamaLinear`` converts the int8 weight to bf16 on every call, then one
    ``torch.mm`` with f32 output) at the decode shape, one decoder layer's
    seven int8 projections, device time by CUDA-graph replay with weights
    rotated past the L2 as in :func:`check_gemv`.  No kernel: the reference
    runs this route in XLA."""
    from mraudio_tpu_torch.config import full_model_config
    from mraudio_tpu_torch.models.llama import LlamaLinear

    cfg = full_model_config().llm
    per_shape = {}
    for kdim, n in ((4096, 4096), (4096, 11008), (11008, 4096)):
        copies = max(1, int(np.ceil(cold_bytes / (kdim * n))))
        x, ws, scale = _gemv_inputs(b, kdim, n, True, gen, copies)
        with torch.device(dev):
            lins = [LlamaLinear(kdim, n, cfg) for _ in range(copies)]
        for lin, w in zip(lins, ws):
            lin.w_int8.data, lin.scale.data = w, scale
        it = [0]

        def call(lins=lins, x=x, it=it):
            it[0] = (it[0] + 1) % len(lins)
            return lins[it[0]](x)

        per_shape[f"{kdim}x{n}"] = graph_ms(call)
        # a row keeps its bits when 4x the rows share the call (a
        # speculative pass): the plain matmul pads decode-shaped calls
        x12 = torch.randn((4 * b, kdim), generator=gen, device=dev).to(torch.bfloat16)
        if not torch.equal(lins[0](x12)[:b], lins[0](x12[:b])):
            raise AssertionError(f"XLA-route projection {kdim}x{n}: rows change with M")
    layer_ms = (4 * per_shape["4096x4096"] + 2 * per_shape["4096x11008"]
                + per_shape["11008x4096"])
    return dict(name="decode projections, XLA route (plain, int8 weights)", b=b,
                ms_by_shape=per_shape, layer_ms=layer_ms,
                per="one decoder layer: q,k,v,o,gate,up,down int8 at B=3",
                rows_bit_identical_at_4x_rows=True)


def check_chunked_attention(dev, b, h, s, kv, d, chunk, gen):
    """Plain ``chunked_attention`` (no kernel: the reference runs it in
    XLA) at the prefill shape over an int8 cache in its stored layout:
    once one-shot and once as segments of ``chunk`` queries, each with its
    ``q_offset`` and the columns written so far, which must give the same
    bits; then held against the flash kernel on the dequantized cache
    under the flash rule.  The scales are rounded to powers of two, so
    the bf16 cache that flash reads is the exact dequantization and both
    compute the same function (with scales as ``quantize_kv`` gives them,
    the flash route's bf16 rounding of the cache alone moves outputs by
    more than the rule).  Each call is timed beside flash."""
    from mraudio_tpu_torch.models.llama import quantize_kv
    from mraudio_tpu_torch.ops.attention import chunked_attention, flash_attention

    q = torch.randn((b, s, h, d), generator=gen, device=dev).to(torch.bfloat16)
    kq, ks = quantize_kv(torch.randn((b, kv, h, d), generator=gen, device=dev))
    vq, vs = quantize_kv(torch.randn((b, kv, h, d), generator=gen, device=dev))
    ks, vs = (torch.exp2(torch.round(torch.log2(t))).transpose(1, 2).contiguous()
              for t in (ks, vs))                                     # (B, H, KV)
    mask = torch.ones((b, kv), dtype=torch.int32, device=dev)
    mask[:, s:] = 0                 # cache columns the prefill has not written
    mask[0, 0] = 0                  # query row 0 of batch row 0: fully masked
    mask[1, 1000:1040] = 0          # interior padding (timestamp slots)
    mask[2, :17] = 0                # left padding
    kw = dict(causal=True, k_scale=ks, v_scale=vs, scales_bhs=True, kv_bshd=True, q_bshd=True)
    cols = torch.arange(kv, device=dev)
    segs = [(o, min(chunk, s - o), mask * (cols < o + min(chunk, s - o)))
            for o in range(0, s, chunk)]

    def one_shot():
        return chunked_attention(q, kq, vq, mask, **kw)

    def segment(o, c, written):
        return chunked_attention(q[:, o:o + c], kq, vq, written, q_offset=o, **kw)

    out = one_shot()
    seg_out = torch.cat([segment(*sg) for sg in segs], dim=1)
    torch.cuda.synchronize()
    if not torch.equal(seg_out, out):
        raise AssertionError("chunked_attention: segments differ from the one-shot call "
                             f"(max |d| {float((seg_out.float() - out.float()).abs().max())})")
    if not bool((out[0, 0] == 0).all()) or not bool(torch.isfinite(out.float()).all()):
        raise AssertionError("chunked_attention: masked row not exactly 0, or non-finite output")
    dt = torch.bfloat16
    kd = kq.to(dt) * ks.transpose(1, 2)[..., None].to(dt)
    vd = vq.to(dt) * vs.transpose(1, 2)[..., None].to(dt)
    if not torch.equal(kd.float(), kq.float() * ks.transpose(1, 2)[..., None]):
        raise AssertionError("chunked_attention check: the bf16 dequantization is not exact")

    def flash():
        return flash_attention(q.transpose(1, 2), kd.transpose(1, 2), vd.transpose(1, 2), mask,
                               causal=True)

    ref = flash()
    torch.cuda.synchronize()
    excess = flash_excess(out.transpose(1, 2), ref)
    max_err = float((out.transpose(1, 2).float() - ref.float()).abs().max())
    if not excess <= 1.0:
        raise AssertionError(f"chunked_attention vs flash: max |err| {max_err}, "
                             f"{excess} x the flash rule")
    ms = cuda_ms(one_shot, iters=2)
    seg_ms = [cuda_ms(lambda sg=sg: segment(*sg), iters=2) for sg in segs]
    flash_ms = cuda_ms(flash, iters=10)
    valid_pairs = sum(int(torch.cumsum(mask[bi].long(), 0)[:s].sum()) for bi in range(b))
    flops = 4.0 * h * d * valid_pairs
    nbytes = 2.0 * 2 * b * s * h * d + 2.0 * b * kv * h * d + 2 * 4.0 * b * h * kv + 4.0 * b * kv
    bms, by = bound_ms(nbytes, flops, PEAK_BF16_TENSOR_FLOPS)
    return dict(name="chunked_attention (plain, int8 KV, one-shot and segmented)",
                shape=dict(b=b, h=h, s=s, kv=kv, d=d, chunk=chunk), segments_bit_identical=True,
                vs_flash_max_abs_err=max_err, vs_flash_err_over_limit=excess, ms=ms,
                segment_q_offsets=[o for o, _, _ in segs], segment_ms=seg_ms,
                flash_ms_same_inputs=flash_ms, bound_ms=bms, bound_by=by)


# --------------------------------------------------------------------------
# Phases 4 and 5: models
# --------------------------------------------------------------------------


QUERIES = ["a man in a red jacket talks to the camera on a busy street",
           "two dogs chase a ball across the beach at sunset",
           "a woman slices vegetables and adds them to a pan"]


def qvh_batch(b: int, n_frms: int, image: int, seconds: float, rate: int, seed: int):
    from mraudio_tpu_torch.models.xinstructblip import GenerateBatch
    from mraudio_tpu_torch.text.prompts import build_query_prompt

    rng = np.random.default_rng(seed)
    duration = [150, 150, 148][:b] + [150] * max(0, b - 3)
    stamps = np.stack([np.linspace(0, d, n_frms, endpoint=False).astype(np.int32)
                       for d in duration])
    t = np.arange(int(seconds * rate)) / rate
    audio = np.stack([
        (3000 * np.sin(2 * np.pi * (220 + 110 * i) * t)
         + rng.normal(0, 800, t.shape)).astype(np.int16) for i in range(b)])
    return GenerateBatch(
        video=rng.integers(0, 256, (b, n_frms, image, image, 3), dtype=np.uint8),
        audio=audio,
        timestamps=stamps,
        duration=duration,
        text_input=[build_query_prompt(QUERIES[i % 3]) for i in range(b)],
    )


def build_model(cfg, audio_cfg, device, seed):
    from mraudio_tpu_torch.models.casting import cast_params_for_inference
    from mraudio_tpu_torch.models.convert_jax import init_random_
    from mraudio_tpu_torch.models.xinstructblip import XInstructBLIP

    model = XInstructBLIP(cfg, audio_cfg=audio_cfg, device=device)
    init_random_(model, seed=seed)
    return cast_params_for_inference(model)


@contextlib.contextmanager
def llm_settings(model, **changes):
    """``LlamaConfig`` fields changed on the language model and on every
    layer that holds the config, for the duration."""
    from mraudio_tpu_torch.config import LlamaConfig

    held = [(m, m.cfg) for m in model.llm.modules()
            if isinstance(getattr(m, "cfg", None), LlamaConfig)]
    for m, c in held:
        m.cfg = c.replace(**changes)
    try:
        yield
    finally:
        for m, c in held:
            m.cfg = c


def small_reference(dev, chunk: int = 512):
    """The slice at narrow width with head_dim 128 (the kernels' shape
    class): the card's run (kernels) against the CPU's (plain versions),
    same weights.  Then a 32-frame batch (a 1078-token prefix) with
    ``prefill_chunk=chunk``: three segments, flash on the first and
    ``chunked_attention`` (int8 scales, ``q_offset``, the written-columns
    mask) on the others; its prefill logits must agree too."""
    from mraudio_tpu_torch.config import AudioFrontendConfig, slice_model_config, tiny_model_config
    from mraudio_tpu_torch.infer.generate import prefill_cache
    from mraudio_tpu_torch.models.casting import cast_params_for_inference
    from mraudio_tpu_torch.models.xinstructblip import XInstructBLIP
    from mraudio_tpu_torch.ops.attention import flash_attention

    base = tiny_model_config(quantization="int8")
    llm = base.llm.replace(hidden_size=256, num_heads=2, num_kv_heads=2, intermediate_size=512,
                           kv_quant="int8", vocab_pad_multiple=8)
    cfg = slice_model_config(base.replace(llm=llm))
    audio_cfg = AudioFrontendConfig(num_mel_bins=16, mel_frames_per_chunk=32)
    cpu = build_model(cfg, audio_cfg, "cpu", seed=1)
    gpu = XInstructBLIP(cfg, audio_cfg=audio_cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    cast_params_for_inference(gpu)
    batch = qvh_batch(3, 4, 28, 3.0, 16000, seed=2)
    long_batch = qvh_batch(3, 32, 28, 3.0, 16000, seed=3)

    results = {}
    for name, model in (("cpu", cpu), ("cuda", gpu)):
        with torch.inference_mode():
            text = model.prepare_text(batch.text_input, batch.timestamps, batch.duration)
            embeds, mask = model.prefix_embeds(*model.device_inputs(batch), text, 4)
            b, s = mask.shape
            pos = (torch.cumsum(mask, -1) - 1).clamp_min(0)
            full = torch.zeros((b, s + 8), dtype=torch.int32, device=mask.device)
            full[:, :s] = mask
            hidden, _ = prefill_cache(model.llm, embeds, pos, full, s + 8)
            logits = model.llm.logits(hidden[:, -1]).cpu()
        texts = model.generate(batch=batch)
        stats = {}
        flash_attention.launches = 0
        with llm_settings(model, prefill_chunk=chunk):
            seg_texts = model.generate(batch=long_batch, stats=stats)
        results[name] = (logits, texts, stats["prefill_logits"].cpu(), seg_texts,
                         stats["prefill_segments"], flash_attention.launches, stats["prefix_len"])
    v = cfg.llm.vocab_size
    err = float((results["cuda"][0][:, :v] - results["cpu"][0][:, :v]).abs().max())
    if not err <= SMALL_LOGIT_ATOL:
        raise AssertionError(f"small model: card vs CPU prefill logits differ by {err}")
    seg_err = float((results["cuda"][2][:, :v] - results["cpu"][2][:, :v]).abs().max())
    segments, launches, prefix = results["cuda"][4:7]
    if segments != 3 or results["cpu"][4] != 3 or launches != cfg.llm.num_layers:
        raise AssertionError(f"small model, segmented: {segments} segments of {prefix} tokens, "
                             f"{launches} flash launches")
    if not seg_err <= SMALL_LOGIT_ATOL:
        raise AssertionError(f"small model, segmented: card vs CPU prefill logits differ by "
                             f"{seg_err}")
    same = results["cuda"][1] == results["cpu"][1]
    return dict(prefill_logit_max_abs_err=err, tol=SMALL_LOGIT_ATOL,
                texts_equal=same, texts_cuda=results["cuda"][1], texts_cpu=results["cpu"][1],
                segmented=dict(prefill_chunk=chunk, prefix_len=prefix, prefill_segments=segments,
                               flash_launches=launches, prefill_logit_max_abs_err=seg_err,
                               texts_equal=results["cuda"][3] == results["cpu"][3]),
                fast=small_fast(cfg, audio_cfg, cpu, dev, batch))


def small_fast(cfg, audio_cfg, cpu_base, dev, batch, max_new_tokens: int = 16):
    """The narrow model under the ``--fast`` preset (temporal-residual ViT,
    the yuv420 wire, grammar decoding at ``spec_width=4``; a 16-token
    budget, so that a span can close), card against CPU from the same
    weights: the prefill logits within the same limit, launch counts on
    the card, and every text on both parsing to windows."""
    from mraudio_tpu_torch.config import RunConfig, apply_fast_preset
    from mraudio_tpu_torch.models.casting import cast_params_for_inference
    from mraudio_tpu_torch.models.xinstructblip import XInstructBLIP
    from mraudio_tpu_torch.ops.attention import flash_attention
    from mraudio_tpu_torch.ops.gemv import decode_gemv

    fast = apply_fast_preset(RunConfig(model=cfg)).model.replace(max_new_tokens=max_new_tokens)
    runs = {}
    for name, device in (("cpu", "cpu"), ("cuda", dev)):
        model = XInstructBLIP(fast, audio_cfg=audio_cfg, device=device)
        model.load_state_dict(cpu_base.state_dict())
        cast_params_for_inference(model)
        stats = {}
        flash_attention.launches = decode_gemv.launches = 0
        texts = model.generate(batch=batch, stats=stats)
        runs[name] = dict(texts=texts, logits=stats["prefill_logits"].cpu(),
                          passes=stats["decode_steps"], tokens=stats["decode_tokens"],
                          launches=(flash_attention.launches, decode_gemv.launches))
    v, layers = cfg.llm.vocab_size, cfg.llm.num_layers
    err = float((runs["cuda"]["logits"][:, :v] - runs["cpu"]["logits"][:, :v]).abs().max())
    if not err <= SMALL_LOGIT_ATOL:
        raise AssertionError(f"small model, fast preset: card vs CPU prefill logits differ by {err}")
    if runs["cuda"]["launches"] != (layers, gemv_launches(cfg.llm, runs["cuda"]["passes"])):
        raise AssertionError(f"small model, fast preset: launches {runs['cuda']['launches']}, "
                             f"{runs['cuda']['passes']} passes")
    windows = {name: [_windows(t) for t in r["texts"]] for name, r in runs.items()}
    return dict(prefill_logit_max_abs_err=err, tol=SMALL_LOGIT_ATOL,
                texts_equal=runs["cuda"]["texts"] == runs["cpu"]["texts"],
                texts_cuda=runs["cuda"]["texts"], texts_cpu=runs["cpu"]["texts"],
                windows=windows, passes={n: r["passes"] for n, r in runs.items()},
                committed_tokens={n: r["tokens"] for n, r in runs.items()},
                launches_cuda=runs["cuda"]["launches"])


def gemv_launches(llm_cfg, passes: int) -> int:
    """GEMV launches of a generate that makes ``passes`` decode passes:
    the seven projections of every layer per pass, plus the lm_head once
    per pass and once for the prefill's last position where its width
    tiles (the narrow model's 264; full width's 32008 does not)."""
    from mraudio_tpu_torch.ops.gemv import supports

    if llm_cfg.decode_gemv != "pallas":
        return 0
    head = int(supports(llm_cfg.hidden_size, llm_cfg.padded_vocab_size))
    return passes * (7 * llm_cfg.num_layers + head) + head


def _windows(text: str) -> list:
    """The windows a grammar-decoded text parses to; any parse failure
    (the scorer's [-1, -1]) raises."""
    from mraudio_tpu_torch.text.postprocess import moment_str_to_list, post_process

    wins = moment_str_to_list(post_process(text))
    if not wins or any(not isinstance(w, list) or len(w) != 2 or w == [-1, -1] for w in wins):
        raise AssertionError(f"grammar-decoded text {text!r} does not parse: {wins}")
    return wins


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profile_generate(model, batch, unprofiled: dict, top: int = 12) -> dict:
    """One more ``generate`` under ``torch.profiler``, broken down by
    :func:`phase_breakdown`."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.generate(batch=batch, stats={})
    trace = Path(__file__).resolve().parent / "build" / "profile" / "generate_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    return phase_breakdown(trace, unprofiled, top)


def phase_breakdown(trace: Path, unprofiled: dict, top: int = 12,
                    names=("encode", "prefill", "decode")) -> dict:
    """Read (and delete) a chrome trace of one ``generate``.  For each phase
    span (``names``: ``encode``, ``prefill``, ``decode``) on the host: the device time
    of every kernel launched inside it, the union of those intervals
    (busy), and the idle share ``1 - busy / span``.  The profiler slows the
    host, so the idle share is also given against the unprofiled run's
    phase seconds (``unprofiled[f"{phase}_s"]``)."""
    events = json.loads(trace.read_text())["traceEvents"]
    trace.unlink()
    spans = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") in names}
    if sorted(spans) != sorted(names):
        raise AssertionError(f"profile: phase spans {sorted(spans)} in the trace")
    device = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") in DEVICE_CATS)
    phases = {}
    for phase, (t0, t1) in spans.items():
        busy, reach, per_name = 0.0, t0, {}
        for a, z, name in device:
            if not t0 <= a < t1:
                continue
            z = min(z, t1)
            busy += max(0.0, z - max(a, reach))
            reach = max(reach, z)
            ms, calls = per_name.get(name, (0.0, 0))
            per_name[name] = (ms + (z - a) / 1e3, calls + 1)
        if busy <= 0:
            raise AssertionError(f"profile: no device time in the {phase} span")
        ranked = sorted(per_name.items(), key=lambda kv: -kv[1][0])
        device_ms = sum(ms for ms, _ in per_name.values())
        phases[phase] = dict(
            span_ms=(t1 - t0) / 1e3, device_busy_ms=busy / 1e3, idle_share=1 - busy / (t1 - t0),
            unprofiled_ms=unprofiled[f"{phase}_s"] * 1e3,
            idle_share_vs_unprofiled=1 - busy / 1e3 / (unprofiled[f"{phase}_s"] * 1e3),
            kernel_names=len(per_name),
            top=[dict(name=name.removeprefix("void ")[:96], ms=ms, calls=calls,
                      share_of_device=ms / device_ms) for name, (ms, calls) in ranked[:top]])
    return phases


def full_generate(dev, seed: int = 0):
    from mraudio_tpu_torch.config import DATASET_MAX_AUDIO_SECONDS, DATASET_N_FRMS
    from mraudio_tpu_torch.config import AudioFrontendConfig, full_model_config, slice_model_config
    from mraudio_tpu_torch.ops.attention import flash_attention
    from mraudio_tpu_torch.ops.gemv import decode_gemv
    from mraudio_tpu_torch.text.postprocess import moment_str_to_list, post_process

    cfg = slice_model_config(full_model_config())
    audio_cfg = AudioFrontendConfig(max_audio_seconds=DATASET_MAX_AUDIO_SECONDS["QVH"])
    t0 = time.perf_counter()
    model = build_model(cfg, audio_cfg, dev, seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    batch = qvh_batch(3, DATASET_N_FRMS["QVH"], cfg.vit.image_size,
                      DATASET_MAX_AUDIO_SECONDS["QVH"], audio_cfg.sampling_rate, seed=seed + 1)

    torch.cuda.reset_peak_memory_stats()
    stats = {}
    flash_attention.launches = 0
    decode_gemv.launches = 0
    t1 = time.perf_counter()
    pending = model.generate_submit(batch=batch, stats=stats)
    tokens = pending[0].cpu()
    texts = model.generate_finalize(pending)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = {"flash_attention": flash_attention.launches, "decode_gemv": decode_gemv.launches}
    steps = stats["decode_steps"]
    layers = cfg.llm.num_layers
    if launches["flash_attention"] != layers:
        raise AssertionError(f"flash launches {launches['flash_attention']} != {layers}")
    if launches["decode_gemv"] != 7 * layers * steps:
        raise AssertionError(f"GEMV launches {launches['decode_gemv']} != 224 x {steps}")
    if not bool(torch.isfinite(stats["prefill_logits"][:, :cfg.llm.vocab_size]).all()):
        raise AssertionError("non-finite prefill logits")
    if len(texts) != 3 or not 1 <= steps <= cfg.max_new_tokens:
        raise AssertionError(f"unexpected output: {len(texts)} texts, {steps} steps")
    windows = [moment_str_to_list(post_process(t)) for t in texts]
    return dict(
        layers=layers, init_s=init_s, params=n_params, param_bytes=param_bytes,
        prefix_len=stats["prefix_len"], encode_s=stats["encode_s"],
        prefill_s=stats["prefill_s"], decode_s=stats["decode_s"], decode_steps=steps,
        wall_s=wall, clips_per_s=3 / wall,
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        launches=launches, texts=texts, windows=windows,
    ), model, batch, stats["prefill_logits"], tokens


def segmented_prefill(model, batch, one_shot: dict, one_shot_logits, chunk: int = 2048):
    """The full-width slice model of ``full_generate`` again, with the JAX
    package's TPU deployment of the prefill: ``prefill_chunk=2048``.
    Flash runs segment 0 of each layer, ``chunked_attention`` the later
    segments, and the GEMV every decode projection.  Then the same batch
    with ``attention_impl="chunked"``, one-shot and segmented, to part the
    logits' differences: flash vs ``chunked_attention`` at the same GEMM
    shapes (both one-shot), and the projections' row count M (chunked
    one-shot vs segmented, whose attention is bit-identical).  Random
    weights have near-tied logits, so the tokens are compared, not
    asserted."""
    from mraudio_tpu_torch.ops.attention import flash_attention
    from mraudio_tpu_torch.ops.gemv import decode_gemv

    cfg = model.llm.cfg
    layers, v = cfg.num_layers, cfg.vocab_size
    runs = {}
    for name, impl, c in (("pallas_segmented", "pallas", chunk),
                          ("chunked_one_shot", "chunked", 0),
                          ("chunked_segmented", "chunked", chunk)):
        stats = {}
        flash_attention.launches = 0
        decode_gemv.launches = 0
        with llm_settings(model, prefill_chunk=c, attention_impl=impl):
            torch.cuda.synchronize()
            t = time.perf_counter()
            texts = model.generate(batch=batch, stats=stats)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        launches = {"flash_attention": flash_attention.launches,
                    "decode_gemv": decode_gemv.launches}
        steps = stats["decode_steps"]
        if stats["prefill_segments"] != (3 if c else 1):
            raise AssertionError(f"{name}: {stats['prefill_segments']} prefill segments")
        if launches["flash_attention"] != (layers if impl == "pallas" else 0):
            raise AssertionError(f"{name}: flash launches {launches}")
        if launches["decode_gemv"] != 7 * layers * steps:
            raise AssertionError(f"{name}: GEMV launches {launches} != 224 x {steps}")
        logits = stats["prefill_logits"][:, :v]
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{name}: non-finite prefill logits")
        runs[name] = dict(logits=logits, texts=texts, launches=launches, decode_steps=steps,
                          prefill_s=stats["prefill_s"], decode_s=stats["decode_s"], wall_s=wall)
    runs["pallas_one_shot"] = dict(logits=one_shot_logits[:, :v], texts=one_shot["texts"])

    def diff(x, y):
        return float((runs[x]["logits"] - runs[y]["logits"]).abs().max())

    seg = runs["pallas_segmented"]
    return dict(prefill_chunk=chunk, prefill_segments=3, launches=seg["launches"],
                decode_steps=seg["decode_steps"], prefill_s=seg["prefill_s"],
                decode_s=seg["decode_s"], wall_s=seg["wall_s"],
                logits_max_abs_diff_vs_one_shot=diff("pallas_segmented", "pallas_one_shot"),
                tokens_equal_one_shot=seg["texts"] == one_shot["texts"], texts=seg["texts"],
                logits_max_abs_diff=dict(
                    flash_vs_chunked_one_shot=diff("pallas_one_shot", "chunked_one_shot"),
                    chunked_segmented_vs_one_shot=diff("chunked_segmented", "chunked_one_shot"),
                    pallas_vs_chunked_segmented=diff("pallas_segmented", "chunked_segmented")),
                chunked=({name: dict(prefill_s=runs[name]["prefill_s"],
                                     decode_s=runs[name]["decode_s"],
                                     tokens_equal_pallas_one_shot=runs[name]["texts"]
                                     == one_shot["texts"])
                          for name in ("chunked_one_shot", "chunked_segmented")}))


@contextlib.contextmanager
def model_settings(model, **changes):
    """``XInstructBLIPConfig`` fields changed on the assembly for the
    duration (the decoder it runs: ``constrained_decoding``,
    ``spec_width``, ``lookup_spec``)."""
    held = model.cfg
    model.cfg = held.replace(**changes)
    try:
        yield
    finally:
        model.cfg = held


def run_decoder(model, batch, **changes) -> dict:
    """One ``generate`` of the slice model with ``changes``, launch counts
    read around it; the tokens kept for comparisons."""
    from mraudio_tpu_torch.ops.attention import flash_attention
    from mraudio_tpu_torch.ops.gemv import decode_gemv

    stats = {}
    flash_attention.launches = 0
    decode_gemv.launches = 0
    with model_settings(model, **changes):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pending = model.generate_submit(batch=batch, stats=stats)
        tokens = pending[0].cpu()
        texts = model.generate_finalize(pending)
        wall = time.perf_counter() - t
    layers = model.llm.cfg.num_layers
    launches = {"flash_attention": flash_attention.launches, "decode_gemv": decode_gemv.launches}
    passes = stats["decode_steps"]
    want = {"flash_attention": layers, "decode_gemv": gemv_launches(model.llm.cfg, passes)}
    if launches != want:
        raise AssertionError(f"{changes}: launches {launches} for {passes} passes, want {want}")
    return dict(tokens=tokens, texts=texts, launches=launches, passes=passes,
                committed_tokens=stats["decode_tokens"], prefill_s=stats["prefill_s"],
                decode_s=stats["decode_s"], wall_s=wall)


def _summary(run: dict) -> dict:
    return {k: v for k, v in run.items() if k != "tokens"}


def grammar_decode(model, batch) -> dict:
    """Grammar-constrained decoding of the slice model at ``spec_width`` 4
    and 1: every text parses to windows, and the tokens of the two widths
    are identical (the reference's contract; here it rests on a per-row
    arithmetic that does not depend on how many rows share a pass).  Then
    the same pair with the default configuration's projections
    (``decode_gemv="xla"``), whose plain matmuls must keep it too."""
    out = {}
    for route in ("pallas", "xla"):
        with llm_settings(model, decode_gemv=route):
            runs = {w: run_decoder(model, batch, constrained_decoding=True, spec_width=w)
                    for w in (4, 1)}
        windows = [_windows(t) for t in runs[4]["texts"]]
        if not torch.equal(runs[4]["tokens"], runs[1]["tokens"]):
            raise AssertionError(f"grammar decoding, decode_gemv={route}: spec_width 4 and 1 "
                                 f"give other tokens: {runs[4]['texts']} vs {runs[1]['texts']}")
        out[route] = dict(windows=windows, tokens_identical=True,
                          spec_width_4=_summary(runs[4]), spec_width_1=_summary(runs[1]))
    return dict(launches=out["pallas"]["spec_width_4"]["launches"], **out)


def lookup_decode(model, batch, greedy: dict, greedy_tokens) -> dict:
    """Lookup self-speculation (``lookup_spec=4``) of the slice model: its
    tokens must be greedy's (``full_generate``)."""
    run = run_decoder(model, batch, lookup_spec=4)
    if not torch.equal(run["tokens"], greedy_tokens):
        raise AssertionError(f"lookup decoding differs from greedy: {run['texts']} vs "
                             f"{greedy['texts']}")
    return dict(tokens_equal_greedy=True, greedy_steps=greedy["decode_steps"], **_summary(run))


def evaluate_cli(fast: bool = False) -> dict:
    """The evaluate CLI in-process at full width in the deployed default
    configuration (``--model-size full``: chunked attention, XLA-route
    projections, ``prefill_chunk=2048``) on 5 synthetic QVH clips at batch
    3 (two batches, the second with a padding row), then the port's
    scorer on its JSONL.  The default configuration routes around both
    kernels: 0 launches of each are asserted.  ``fast`` adds ``--fast``
    (the yuv420 wire, the temporal-residual ViT, grammar decoding at
    ``spec_width=4``): then no prediction may be invalid."""
    from mraudio_tpu_torch.cli import evaluate as cli
    from mraudio_tpu_torch.eval.mr_eval import eval_submission
    from mraudio_tpu_torch.eval.span_utils import load_jsonl
    from mraudio_tpu_torch.ops.attention import flash_attention
    from mraudio_tpu_torch.ops.gemv import decode_gemv

    root = Path(__file__).resolve().parent / "build" / ("smoke_fast" if fast else "smoke")
    root.mkdir(parents=True, exist_ok=True)
    extra = ["--fast"] if fast else []
    anns = [{"vid": f"v{i}", "qid": i, "query": QUERIES[i % 3], "duration": 150,
             "relevant_windows": [[10.0 + 24 * i, 34.0 + 24 * i]]} for i in range(5)]
    gt, out = root / "annotations.jsonl", root / "predictions.jsonl"
    gt.write_text("".join(json.dumps(a) + "\n" for a in anns))
    out.unlink(missing_ok=True)

    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    decode_gemv.launches = 0
    t = time.perf_counter()
    result = cli.main(["--annotation-file", str(gt), "--output-file", str(out),
                       "--model-size", "full", "--video-source", "synthetic",
                       "--batch-size", "3", *extra])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {"flash_attention": flash_attention.launches, "decode_gemv": decode_gemv.launches}
    if launches != {"flash_attention": 0, "decode_gemv": 0}:
        raise AssertionError(f"evaluate (default config{', --fast' if fast else ''}) launched "
                             f"kernels: {launches}")
    records = load_jsonl(str(out))
    if [r["qid"] for r in records] != list(range(5)) or records != result["records"]:
        raise AssertionError(f"evaluate wrote qids {[r['qid'] for r in records]}")
    for r in records:
        wins = r["pred_relevant_windows"]
        if (set(r) != {"qid", "query", "vid", "pred_relevant_windows", "raw_out"}
                or not isinstance(r["raw_out"], str) or not wins
                or not all(isinstance(w, list) and len(w) == 2 for w in wins)):
            raise AssertionError(f"evaluate: record off the submission schema: {r}")
    batches = result["batches"]
    if len(batches) != 2 or any(bt["prefill_segments"] != 3 for bt in batches):
        raise AssertionError(f"evaluate: batches {batches}")
    metrics = eval_submission(records, anns, verbose=False)
    if fast and metrics["brief"]["MR-full-invalid_pred_num"] != 0:
        raise AssertionError(f"fast evaluate: invalid predictions {metrics['brief']}")
    peak = torch.cuda.max_memory_allocated()

    # the first batch once more under --profile-dir: where its time goes
    gt3 = root / "annotations_batch0.jsonl"
    gt3.write_text("".join(json.dumps(a) + "\n" for a in anns[:3]))
    cli.main(["--annotation-file", str(gt3), "--output-file", str(root / "profiled.jsonl"),
              "--model-size", "full", "--video-source", "synthetic", "--batch-size", "3",
              "--profile-dir", str(root / "profile"), *extra])
    breakdown = phase_breakdown(root / "profile" / "trace.json", batches[0])
    return dict(records=len(records), launches=launches, clips_per_sec=result["clips_per_sec"],
                wall_s_with_model_build=wall, stages=result["stages"], batches=batches,
                prefix_len=batches[0]["prefix_len"], peak_mem_bytes=peak,
                brief=dict(metrics["brief"]), raw_out=[r["raw_out"] for r in records],
                profile_batch0=breakdown)


# --------------------------------------------------------------------------
# Phases 12-15: the serving path
# --------------------------------------------------------------------------

# obs_score on the card vs a dense f32 computation of the same inputs: f32
# sums in other orders; random weights give logits of O(100), so a
# probability may move by ~1e-4 of itself
OBS_RTOL = 1e-3
OBS_ATOL_PER_QUERY_HEAD = 1e-6


def serve_annotations(n: int) -> list:
    return [{"vid": f"s{i}", "qid": i, "query": QUERIES[i % 3], "duration": 150,
             "relevant_windows": [[10.0 + 24 * (i % 5), 34.0 + 24 * (i % 5)]]} for i in range(n)]


def set_launches(value: int = 0) -> None:
    from mraudio_tpu_torch.ops.attention import flash_attention
    from mraudio_tpu_torch.ops.gemv import decode_gemv

    flash_attention.launches = decode_gemv.launches = value


def read_launches() -> dict:
    from mraudio_tpu_torch.ops.attention import flash_attention
    from mraudio_tpu_torch.ops.gemv import decode_gemv

    return {"flash_attention": flash_attention.launches, "decode_gemv": decode_gemv.launches}


def check_records(records: list, n: int, what: str) -> None:
    """``n`` records, one per qid, each on the serve schema with windows
    that the parser produced (lists of [start, end])."""
    if sorted(r["qid"] for r in records) != list(range(n)):
        raise AssertionError(f"{what}: qids {sorted(r['qid'] for r in records)}")
    for r in records:
        wins = r["pred_relevant_windows"]
        if (set(r) != {"qid", "query", "vid", "pred_relevant_windows", "raw_out", "latency_s"}
                or not isinstance(r["raw_out"], str) or not isinstance(wins, list) or not wins
                or not all(isinstance(w, list) and len(w) == 2 for w in wins)
                or not r["latency_s"] > 0):
            raise AssertionError(f"{what}: record off the serve schema: {r}")


def serve_cli(name: str, extra: list, n: int = 6) -> dict:
    """The serve CLI in-process at full width in the deployed default
    configuration (no kernel: 0 launches asserted) on ``n`` synthetic QVH
    requests; its records checked, its stats line and the peak memory
    returned."""
    from mraudio_tpu_torch.cli import serve as cli
    from mraudio_tpu_torch.eval.span_utils import load_jsonl

    root = Path(__file__).resolve().parent / "build" / f"smoke_{name}"
    root.mkdir(parents=True, exist_ok=True)
    ann, out = root / "annotations.jsonl", root / "predictions.jsonl"
    ann.write_text("".join(json.dumps(a) + "\n" for a in serve_annotations(n)))
    out.unlink(missing_ok=True)
    torch.cuda.reset_peak_memory_stats()
    set_launches(0)
    t = time.perf_counter()
    stats = cli.main(["--annotation-file", str(ann), "--output-file", str(out),
                      "--model-size", "full", "--video-source", "synthetic", *extra])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = read_launches()
    if launches != {"flash_attention": 0, "decode_gemv": 0}:
        raise AssertionError(f"{name}: the default configuration launched kernels: {launches}")
    records = load_jsonl(str(out))
    check_records(records, n, name)
    if stats["requests"] != n:
        raise AssertionError(f"{name}: stats {stats}")
    return dict(stats=stats, launches=launches, peak_mem_bytes=torch.cuda.max_memory_allocated(),
                wall_s_with_model_build=wall, raw_out=[r["raw_out"] for r in records])


def drive_engine(engine, requests: list, cancel_id=None, trace: bool = False):
    """Run ``requests`` through the engine, admitting what fits whenever a
    slot is free; ``cancel_id`` is cancelled after its first token.
    Returns ``(tokens by request id, decode dispatches, seconds)``."""
    from torch.profiler import record_function

    pending, results, dispatches = list(requests), {}, 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    with record_function("engine") if trace else contextlib.nullcontext():
        while (pending or engine.active.any() or engine._inflight
               or engine.admission_pending()):
            if pending and engine.free_slots():
                del pending[:engine.submit_many(pending)]
            if engine.active.any():
                dispatches += 1
            if engine.active.any() or engine._inflight:
                for c in engine.step():
                    results[c.request_id] = list(c.token_ids)
            if cancel_id is not None:
                for i in range(engine.max_slots):
                    if engine.slot_request[i] == cancel_id and engine.emitted[i]:
                        engine.cancel(cancel_id)
                        cancel_id = None
        torch.cuda.synchronize()
    return results, dispatches, time.perf_counter() - t


def same_tokens(results: dict, ref, eos: int, what: str) -> None:
    """Each request's tokens are the reference row's up to the request's
    end (EOS or the budget)."""
    for rid, tokens in results.items():
        want = [int(x) for x in ref[rid]]
        if tokens != want[:len(tokens)] or not (len(tokens) == len(want) or tokens[-1] == eos):
            raise AssertionError(f"{what}: request {rid} gives {tokens}, want {want}")


def serve_model(dev):
    """The deployed default configuration in-process, random weights from
    ``train.seed``, and 4 synthetic QVH requests encoded up front (device-
    resident prefixes)."""
    from mraudio_tpu_torch.cli.serve import encode_requests
    from mraudio_tpu_torch.config import DataConfig, RunConfig, full_model_config
    from mraudio_tpu_torch.data.dataset import MRDataset
    from mraudio_tpu_torch.infer.evaluate import build_model as build_run_model
    from mraudio_tpu_torch.models.casting import cast_params_for_inference

    cfg = RunConfig(model=full_model_config(),
                    data=DataConfig.for_dataset("QVH", video_source="synthetic"))
    model = cast_params_for_inference(build_run_model(cfg, dev))
    dataset = MRDataset(cfg.data, annotations=serve_annotations(4))
    requests = encode_requests(model, dataset, device_embeds=True, encode_batch=2,
                               host_ahead=0)
    return model, requests


def serve_identities(model, requests) -> dict:
    """The reference's serving contracts on the card, at full width in the
    deployed default configuration with 4 slots: three requests' tokens
    equal the offline ``greedy_generate``'s at batch 3, at pipeline depth
    2 and 1, at 2 steps per dispatch, at ``spec_width`` 4 with hints, and
    with a fourth request cancelled mid-decode.  ``serve()`` reports its
    timeouts, and Poisson arrivals give the burst run's records.  Returns
    the phase's results and the offline tokens."""
    from mraudio_tpu_torch.cli.serve import poisson_arrivals, serve
    from mraudio_tpu_torch.infer.generate import greedy_generate
    from mraudio_tpu_torch.infer.serving import ContinuousBatcher

    llm, eos = model.llm, model.llm_tokenizer.eos_token_id
    max_new = model.cfg.max_new_tokens
    reqs = [r for r, _ in requests]
    s = reqs[0].prefix_embeds.shape[0]
    dev = model.device
    t = time.perf_counter()
    offline = greedy_generate(
        llm, torch.stack([r.prefix_embeds for r in reqs[:3]]),
        torch.from_numpy(np.stack([r.prefix_mask for r in reqs[:3]])).to(dev), max_new,
        eos).cpu().numpy()
    offline_s = time.perf_counter() - t
    runs = {}
    for name, kw in (("depth_2", {}), ("depth_1", dict(pipeline_depth=1)),
                     ("steps_2", dict(steps_per_dispatch=2)), ("spec_4", dict(spec_width=4))):
        engine = ContinuousBatcher(llm, s, max_new, eos, max_slots=4, **kw)
        if name == "depth_2":         # the traced run
            tokens, dispatches, secs, profile = profile_engine(engine, reqs[:3])
        else:
            tokens, dispatches, secs = drive_engine(engine, reqs[:3])
        engine.close()
        same_tokens(tokens, offline, eos, f"engine {name} vs offline greedy")
        runs[name] = dict(dispatches=dispatches, seconds=secs)
    engine = ContinuousBatcher(llm, s, max_new, eos, max_slots=4)
    tokens, dispatches, secs = drive_engine(engine, reqs, cancel_id=3)
    engine.close()
    if sorted(tokens) != [0, 1, 2]:
        raise AssertionError(f"cancel run completed {sorted(tokens)}")
    same_tokens(tokens, offline, eos, "engine with request 3 cancelled")
    runs["cancel_mid_decode"] = dict(dispatches=dispatches, seconds=secs)

    burst, burst_stats = serve(model, requests[:3], 4, max_new)
    load, load_stats = serve(model, requests[:3], 4, max_new,
                             arrivals=poisson_arrivals(3, 0.5, seed=0))

    def strip(records):
        return sorted(({k: v for k, v in r.items() if k != "latency_s"} for r in records),
                      key=lambda r: r["qid"])

    check_records(burst, 3, "serve burst")
    if strip(load) != strip(burst):
        raise AssertionError("serve: Poisson arrivals give other records than the burst")
    _, timeout_stats = serve(model, requests[:3], 4, max_new,
                             arrivals=poisson_arrivals(3, 50.0, seed=0), request_timeout_s=1e-3)
    if not (timeout_stats["timeouts"] >= 1
            and timeout_stats["timeouts"] + timeout_stats["requests"] == 3):
        raise AssertionError(f"serve: timeouts not reported: {timeout_stats}")
    return dict(prefix_len=s, offline_greedy_s=offline_s, tokens_identical=True, runs=runs,
                engine_profile=profile,
                burst_stats=burst_stats, load_stats=load_stats,
                load_records_equal_burst=True, timeouts=timeout_stats["timeouts"]), offline


def profile_engine(engine, requests):
    """``drive_engine`` under ``torch.profiler``: its results, and the
    device's busy time and idle share over the ``engine`` span.  The
    profiler slows the host, so the share overstates the unprofiled
    run's."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tokens, dispatches, secs = drive_engine(engine, requests, trace=True)
    trace = Path(__file__).resolve().parent / "build" / "profile" / "engine_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    breakdown = phase_breakdown(trace, {"engine_s": secs}, names=("engine",))["engine"]
    return tokens, dispatches, secs, breakdown


def _dense_obs_scores(q_obs, k_full, k_scale, kv_valid, q_start: int) -> torch.Tensor:
    """The observation-window statistic in f32 over all heads at once."""
    b, w, h, d = q_obs.shape
    kv = k_full.shape[1]
    logits = torch.einsum("bwhd,bkhd->bhwk", q_obs.float(), k_full.float()) * (d ** -0.5)
    logits = logits * k_scale[:, :, None, :]
    cols = torch.arange(kv, device=q_obs.device)
    ok = (cols[None, :] <= (q_start + torch.arange(w, device=q_obs.device))[:, None])[None, None]
    ok = ok & (kv_valid[:, None, None, :] > 0)
    probs = torch.softmax(torch.where(ok, logits, -1e30), dim=-1)
    probs = probs * kv_valid[:, q_start:q_start + w].float()[:, None, :, None]
    return probs.sum(dim=(1, 2))


def _plain_selection(obs_score, kv_valid, keep: int, sink: int, obs: int, s: int) -> np.ndarray:
    """The reference's rule on the host: top ``keep`` columns by score,
    protected columns first, invalid last, lowest index first among ties,
    in column order."""
    score = obs_score[:, :s].double().cpu().numpy()
    col = np.arange(s)
    score = np.where((col < sink) | (col >= s - obs), 1e30, score)
    score = np.where(kv_valid[:, :s].cpu().numpy() > 0, score, -1e30)
    return np.sort(np.argsort(-score, axis=-1, kind="stable")[:, :keep], axis=-1)


def serve_deployed_checks(model, requests, offline_tokens, kv_keep: int = 1784) -> dict:
    """``bench.py``'s serve profile on the card: one admission of two
    requests under ``kv_keep`` (1784 there).  Per layer, the kept columns are the
    plain rule's selection from the card's own ``obs_score``, and that
    score lies within OBS_RTOL / OBS_ATOL of a dense f32 computation on the
    same inputs.  Then, with ``kv_keep`` above the prefix length (every
    column kept), 2-wide admissions and 2 steps per dispatch give the
    offline greedy tokens ``offline_tokens`` of the first three requests."""
    import mraudio_tpu_torch.models.llama as llama_mod
    from mraudio_tpu_torch.infer.serving import ContinuousBatcher
    from mraudio_tpu_torch.models.llama import compaction_sizes

    llm, eos = model.llm, model.llm_tokenizer.eos_token_id
    max_new = model.cfg.max_new_tokens
    reqs = [r for r, _ in requests]
    s = reqs[0].prefix_embeds.shape[0]
    calls = []
    real = llama_mod.observation_scores

    def recording(q_obs, k_full, k_scale, kv_valid, q_start, score):
        out = real(q_obs, k_full, k_scale, kv_valid, q_start, score)
        calls.append((q_obs, k_full, k_scale, kv_valid, q_start, score, out))
        return out

    with llm_settings(model, kv_keep=kv_keep):
        engine = ContinuousBatcher(llm, s, max_new, eos, max_slots=4, max_prefill_batch=2,
                                   steps_per_dispatch=2)
        llama_mod.observation_scores = recording
        try:
            engine.begin_admission(reqs[:2])
            while engine._admission["chunk"] < len(engine._chunk_starts):
                engine.admission_step()
        finally:
            llama_mod.observation_scores = real
        ad = engine._admission
        batch_cache, pmask = ad["cache"], ad["pmask"]
        engine.admission_step()                       # the epilogue: compaction, slots
        keep, sink, obs = compaction_sizes(llm.cfg, s)
        if len(calls) != llm.cfg.num_layers:
            raise AssertionError(f"observation scores computed {len(calls)} times")
        worst = 0.0
        max_err = 0.0
        for i, (q_obs, k_full, k_scale, kv_valid, q_start, before, after) in enumerate(calls):
            ref = before + _dense_obs_scores(q_obs, k_full, k_scale, kv_valid, q_start)
            w, h = q_obs.shape[1], q_obs.shape[2]
            err = (after - ref).abs()
            limit = OBS_RTOL * ref.abs() + OBS_ATOL_PER_QUERY_HEAD * w * h
            worst = max(worst, float((err / limit).max()))
            max_err = max(max_err, float(err.max()))
            if not worst <= 1.0:
                raise AssertionError(f"layer {i}: obs_score {worst} x its limit from dense f32")
            idx = torch.from_numpy(_plain_selection(batch_cache[i]["obs_score"], pmask, keep,
                                                    sink, obs, s)).to(model.device)
            kept = engine.cache[i]
            for name in ("k", "v"):
                want = batch_cache[i][name][:2].gather(
                    1, idx[:, :, None, None].expand(-1, -1, *batch_cache[i][name].shape[2:]))
                if not torch.equal(kept[name][:2, :keep], want):
                    raise AssertionError(f"layer {i}: kept {name} columns are not the plain "
                                         "selection's")
            for name in ("k_scale", "v_scale"):
                want = batch_cache[i][name][:2].gather(
                    2, idx[:, None, :].expand(-1, batch_cache[i][name].shape[1], -1))
                if not torch.equal(kept[name][:2, :, :keep], want):
                    raise AssertionError(f"layer {i}: kept {name} is not the plain selection's")
            if not torch.equal(kept["valid"][:2, :keep], pmask[:2].gather(1, idx)):
                raise AssertionError(f"layer {i}: the valid leaf is not the plain selection's")
        engine.close()
        del batch_cache, calls, ad

    with llm_settings(model, kv_keep=100000):
        engine = ContinuousBatcher(llm, s, max_new, eos, max_slots=4, max_prefill_batch=2,
                                   steps_per_dispatch=2)
        tokens, dispatches, secs = drive_engine(engine, reqs[:3])
        engine.close()
    same_tokens(tokens, offline_tokens, eos, "kv_keep above the prefix vs uncompacted")
    return dict(kv_keep=kv_keep, keep=keep, sink=sink, obs=obs, layers_checked=llm.cfg.num_layers,
                obs_score_max_abs_err=max_err, obs_score_err_over_limit=worst,
                kept_columns_equal_plain_selection=True,
                keep_all_tokens_equal_uncompacted=True, keep_all_dispatches=dispatches,
                keep_all_seconds=secs)


def serve_slice(model, requests) -> dict:
    """The engine in the slice configuration (flash prefill, GEMV decode
    projections, one-shot prefill), greedy and at ``spec_width`` 4: 32
    flash launches per admission and 224 GEMV launches per dispatch
    (M = 4 slots, or 4 x 4 rows in a verify pass), and identical tokens."""
    from mraudio_tpu_torch.infer.serving import ContinuousBatcher

    llm, eos = model.llm, model.llm_tokenizer.eos_token_id
    layers = llm.cfg.num_layers
    reqs = [r for r, _ in requests[:3]]
    s = reqs[0].prefix_embeds.shape[0]
    runs, tokens = {}, {}
    with llm_settings(model, attention_impl="pallas", decode_gemv="pallas", prefill_chunk=0):
        for name, w in (("greedy", 1), ("spec_4", 4)):
            engine = ContinuousBatcher(llm, s, model.cfg.max_new_tokens, eos, max_slots=4,
                                       spec_width=w)
            torch.cuda.reset_peak_memory_stats()
            set_launches(0)
            tokens[name], dispatches, secs = drive_engine(engine, reqs)
            launches = read_launches()
            engine.close()
            want = {"flash_attention": layers, "decode_gemv": 7 * layers * dispatches}
            if launches != want:
                raise AssertionError(f"serve slice {name}: launches {launches} for "
                                     f"{dispatches} dispatches, want {want}")
            runs[name] = dict(launches=launches, dispatches=dispatches, seconds=secs,
                              peak_mem_bytes=torch.cuda.max_memory_allocated())
    if tokens["greedy"] != tokens["spec_4"]:
        raise AssertionError(f"serve slice: spec_width 4 gives other tokens than greedy")
    return dict(tokens_identical=True, **runs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="also write every phase's result to this JSON file")
    ap.add_argument("--only", default="",
                    help="comma-separated phases to run (kernels, models, evaluate, serve); "
                         "a partial run prints no summary and no ok line")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — no card", file=sys.stderr)
        return 1
    from mraudio_tpu_torch.ops import build   # fails outside a checkout of the repo

    only = set(filter(None, args.only.split(",")))

    def on(group: str) -> bool:
        return not only or group in only

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    results = {}

    t = time.perf_counter()
    card = card_line()
    results["device"] = dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                             name=torch.cuda.get_device_name(0))
    emit({"phase": "device", **results["device"], "seconds": time.perf_counter() - t})

    t = time.perf_counter()
    build_s = build.build_all()
    for name in build.KERNELS:
        build.load(name)
    results["build"] = dict(nvcc_s=build_s)
    emit({"phase": "build", **results["build"], "seconds": time.perf_counter() - t})

    # the main path's shapes: a 5353-token QVH prefix of 3 clips, a cache of
    # prefix + 64-token budget + the 16-column widest draft
    b, h, d, s, kv = 3, 32, 128, 5353, 5353 + 64 + 16
    gen = torch.Generator(device=dev).manual_seed(0)

    def layer(rs):      # one decoder layer's GEMVs: q, k, v, o (4096²), gate, up, down
        per_layer = [rs[0]] * 4 + [rs[1]] * 2 + [rs[2]]
        return {key: sum(r[key] for r in per_layer)
                for key in ("ms", "plain_ms", "library_ms", "bound_ms")}

    if on("kernels"):
        t = time.perf_counter()
        flash = check_flash(dev, b, h, s, kv, d, gen)
        emit({"phase": "kernel", **flash})
        flash_cases = check_flash_cases(dev, gen)
        emit({"phase": "kernel", "name": "flash_attention, smaller cases", "cases": flash_cases})
        gemvs = []
        for kdim, n, int8 in ((4096, 4096, True), (4096, 11008, True), (11008, 4096, True),
                              (4096, 4096, False)):
            r = check_gemv(dev, b, kdim, n, int8, gen)
            emit({"phase": "kernel", **r})
            gemvs.append(r)
        # M = 12: a speculative pass of 3 rows; M = 4 and 16: the engine's
        # 4 slots, greedy and in a verify pass of 4 positions
        gemvs_m = {}
        for m in (12, 4, 16):
            gemvs_m[m] = []
            for kdim, n in ((4096, 4096), (4096, 11008), (11008, 4096)):
                r = check_gemv(dev, m, kdim, n, True, gen, by_cluster=False)
                emit({"phase": "kernel", **r})
                gemvs_m[m].append(r)
        gemv_rows = check_gemv_rows(gen)
        emit({"phase": "kernel", "name": "decode_gemv, M=12 rows vs M=3 launches",
              "rows": gemv_rows})
        gemv_rows16 = check_gemv_rows(gen, m=16, split=4)
        emit({"phase": "kernel", "name": "decode_gemv, M=16 rows vs M=4 launches",
              "rows": gemv_rows16})
        gemv_other = check_gemv_other(gen)
        emit({"phase": "kernel", "name": "decode_gemv, other row counts and shapes",
              "vs_plain": gemv_other})
        per_row = check_per_row_attention(dev, b, h, s, 4, d, gen)
        emit({"phase": "plain_op", **per_row})
        chunked = check_chunked_attention(dev, b, h, s, kv, d, 2048, gen)
        emit({"phase": "plain_op", **chunked})
        xla_proj = check_xla_projections(dev, b, gen)
        emit({"phase": "plain_op", **xla_proj})

        gemv_layer = layer(gemvs)
        gemv_layer_m = {m: layer(rs) for m, rs in gemvs_m.items()}
        emit({"phase": "kernel", "name": "decode_gemv, one decoder layer",
              "b3": gemv_layer, **{f"b{m}": v for m, v in gemv_layer_m.items()}})
        results["kernels"] = dict(flash=flash, flash_cases=flash_cases, gemv=gemvs,
                                  gemv_m=gemvs_m, gemv_rows=gemv_rows, gemv_rows16=gemv_rows16,
                                  gemv_other=gemv_other, per_row_attention=per_row,
                                  chunked_attention=chunked, xla_projections=xla_proj,
                                  gemv_layer=gemv_layer, gemv_layer_m=gemv_layer_m)
        emit({"phase": "kernels", "seconds": time.perf_counter() - t})

    if on("models"):
        t = time.perf_counter()
        results["small"] = small_reference(dev)
        emit({"phase": "small_reference", **results["small"], "seconds": time.perf_counter() - t})

        t = time.perf_counter()
        full, model, batch, full_logits, greedy_tokens = full_generate(dev)
        results["full"] = full
        emit({"phase": "full_generate", **full, "seconds": time.perf_counter() - t})

        t = time.perf_counter()
        results["profile"] = profile_generate(model, batch, full)
        emit({"phase": "profile", **results["profile"], "seconds": time.perf_counter() - t})

        t = time.perf_counter()
        results["segmented"] = segmented_prefill(model, batch, full, full_logits)
        emit({"phase": "segmented_prefill", **results["segmented"],
              "seconds": time.perf_counter() - t})

        t = time.perf_counter()
        results["grammar"] = grammar_decode(model, batch)
        emit({"phase": "grammar_generate", **results["grammar"],
              "seconds": time.perf_counter() - t})

        t = time.perf_counter()
        results["lookup"] = lookup_decode(model, batch, full, greedy_tokens)
        emit({"phase": "lookup_generate", **results["lookup"], "seconds": time.perf_counter() - t})
        del model, batch, full_logits
        gc.collect()
        torch.cuda.empty_cache()

    if on("evaluate"):
        t = time.perf_counter()
        results["evaluate"] = evaluate_cli()
        emit({"phase": "evaluate", **results["evaluate"], "seconds": time.perf_counter() - t})

        t = time.perf_counter()
        results["fast_evaluate"] = evaluate_cli(fast=True)
        emit({"phase": "fast_evaluate", **results["fast_evaluate"],
              "seconds": time.perf_counter() - t})

    if on("serve"):
        t = time.perf_counter()
        results["serve"] = serve_cli("serve", [])
        emit({"phase": "serve", **results["serve"], "seconds": time.perf_counter() - t})
        gc.collect()
        torch.cuda.empty_cache()

        # bench.py's serve profile (bench.py:640-700)
        t = time.perf_counter()
        deployed_cli = serve_cli("serve_deployed", [
            "--slots", "4", "--max-prefill-batch", "2", "--kv-keep", "1784",
            "--steps-per-dispatch", "2", "--encode-mode", "inline", "--encode-batch", "2",
            "--encode-ahead", "1"])
        deployed_cli_s = time.perf_counter() - t
        gc.collect()
        torch.cuda.empty_cache()

        t = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        model, requests = serve_model(dev)
        set_launches(0)
        results["serve_identities"], offline = serve_identities(model, requests)
        if read_launches() != {"flash_attention": 0, "decode_gemv": 0}:
            raise AssertionError(f"serve identities launched kernels: {read_launches()}")
        results["serve_identities"]["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        emit({"phase": "serve_identities", **results["serve_identities"],
              "seconds": time.perf_counter() - t})

        t = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        checks = serve_deployed_checks(model, requests, offline)
        results["serve_deployed"] = dict(cli=deployed_cli, **checks,
                                         checks_peak_mem_bytes=torch.cuda.max_memory_allocated())
        emit({"phase": "serve_deployed", **results["serve_deployed"],
              "seconds": deployed_cli_s + time.perf_counter() - t})

        t = time.perf_counter()
        results["serve_slice"] = serve_slice(model, requests)
        emit({"phase": "serve_slice", **results["serve_slice"],
              "seconds": time.perf_counter() - t})
        del model, requests
        gc.collect()
        torch.cuda.empty_cache()

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=str)
    if only:
        emit({"partial": sorted(only)})
        return 0

    launches_by_path = {name: {"full_generate": full["launches"][name],
                               "segmented_prefill": results["segmented"]["launches"][name],
                               "grammar_generate": results["grammar"]["launches"][name],
                               "lookup_generate": results["lookup"]["launches"][name],
                               "evaluate": results["evaluate"]["launches"][name],
                               "fast_evaluate": results["fast_evaluate"]["launches"][name],
                               "serve": results["serve"]["launches"][name],
                               "serve_deployed": results["serve_deployed"]["cli"]["launches"][name],
                               "serve_slice_greedy":
                                   results["serve_slice"]["greedy"]["launches"][name],
                               "serve_slice_spec_4":
                                   results["serve_slice"]["spec_4"]["launches"][name]}
                        for name in ("flash_attention", "decode_gemv")}

    kernels = [
        dict(name="flash_attention", route="cuda",
             source="mraudio_tpu_torch/csrc/flash_attention.cu",
             replaces="mraudio_tpu/ops/attention.py:471",
             launches=full["launches"]["flash_attention"],
             launches_by_path=launches_by_path["flash_attention"],
             max_abs_err=flash["max_abs_err"], ms=flash["ms"], plain_ms=flash["plain_ms"],
             bound_ms=flash["bound_ms"], bound_by=flash["bound_by"],
             library_ms=flash["library_ms"]),
        dict(name="decode_gemv", route="cuda",
             source="mraudio_tpu_torch/csrc/decode_gemv.cu",
             replaces="mraudio_tpu/ops/gemv.py:109",
             launches=full["launches"]["decode_gemv"],
             launches_by_path=launches_by_path["decode_gemv"],
             max_abs_err=max(r["max_abs_err"] for r in gemvs + sum(gemvs_m.values(), [])),
             per="one decoder layer: q,k,v,o,gate,up,down int8 at B=3",
             bound_by="bytes", **gemv_layer,
             **{f"b{m}": v for m, v in gemv_layer_m.items()}),
    ]
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
