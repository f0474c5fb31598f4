"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--out results.json]
                          [--only kernels,models,evaluate,serve,converted,train,videollama,quant,
                                  parallel]

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
   at 4x the rows.  Then both kernels at the per-rank shapes of tensor
   parallelism over 2 and 4 cards (flash over 16 and 8 heads; the GEMV
   on each rank's column or row shard of one decoder layer, 11008/4 =
   2752 included), and at the 2.1-AV decoder's (flash at S = 11123 over
   14 query heads and 2 KV heads, and 7 and 1; the bf16 GEMV at M = 1 on
   each rank's six shard shapes, its 3584 x 128 k/v shard and its
   vocabulary shard of the lm_head included), under the same checks and
   timings;
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
6. profile: one more generate under ``torch.profiler``, decoding
   ``PROFILE_TOKENS`` (16) tokens: each phase's (encode, prefill, decode)
   device time per kernel and idle share;
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
    its first batch once more under ``--profile-dir`` with a 16-token
    budget, broken down as in 6 (the card's machine has no libav, so the
    native media source and ``data/media.py``'s mp4s cannot run there);
11. fast evaluate: the same with ``--fast`` (the yuv420 wire, the
    temporal-residual ViT, grammar decoding): 0 kernel launches and 0
    invalid predictions asserted;
12. serve: the serve CLI in-process at full width (the decoder cut to
    ``CUT_LAYERS`` = 16 since the 2.1-AV mesh phases came) in its default
    configuration (4 slots, 1 step per dispatch, pipeline depth 2,
    upfront encode) on 6 synthetic QVH requests, so that two slots are
    reused: 6 records on the serve schema, 0 kernel launches, the stats
    line and the peak memory;
13. serve identities: 3 requests of the same configuration in-process,
    cut to 8 decoder layers, its LoRA B seeded non-zero; each
    request's engine tokens must equal the offline ``greedy_generate`` at
    batch 3, at pipeline depth 2 and 1, 2 steps per dispatch,
    ``spec_width`` 4 with hints and with a fourth request cancelled mid-
    decode; ``serve()`` must report its timeouts, and Poisson arrivals
    must give the burst run's records; the depth-2 run is traced (device
    idle share of the ``engine`` span);
14. serve deployed: ``bench.py``'s serve profile through the CLI (as 12, at
    ``CUT_LAYERS`` decoder layers; 4 slots,
    ``--max-prefill-batch 2``, ``--kv-keep 1784``, 2 steps per dispatch,
    inline encode in groups of 2 with one group prepared ahead) on 6
    requests; then, for one admission, every layer's kept columns must be
    the plain rule's selection from the card's own ``obs_score``, which
    must lie within its limit of a dense f32 computation, and ``kv_keep``
    above the prefix length must give the uncompacted tokens;
15. serve slice: the engine in the slice configuration, greedy and at
    ``spec_width`` 4: a flash launch per layer and admission, 7 GEMV
    launches per layer and dispatch, identical tokens;
16. converted: checkpoints in the reference's key layouts, fabricated at
    full width with the depth cut (Vicuna 2 decoder layers, EVA-ViT-g 2
    blocks; BEATs and the Q-Former and BLIP-2 bundles whole), converted,
    quantized and stored (host seconds and bytes per step); the model
    from the store equals the model from the checkpoints, bit for bit;
    the GEMV on a converted layer's ``quantize_llama_int8`` weights; a
    slice-configuration generate with its launch counts; the evaluate CLI
    from the checkpoints and from the store (byte-identical JSONL, 0
    launches); the serve CLI from the store; ``cli.parity --fabricate``
    at tiny size, alone and against its own predictions (PASS).  Its files
    live under ``build/converted`` and are deleted at the end;
17. train: the finetune CLI in a process of its own at full width in
    its default configuration (int8 Vicuna-7B cut to ``CUT_LAYERS`` = 16
    decoder layers, LoRA r 8, block remat, AdamW under 2 accumulation
    steps, crops): 8 synthetic QVH
    clips at batch 2, 1 epoch, validation on 2; every micro-step timed
    (seconds per micro-step, clips/s, MFU from ``utils/flops.py``), the
    4th traced and split by the ``encode``, ``loss_fwd_bwd`` and
    ``optimizer`` spans; finite losses, every LoRA B moved, the
    checkpoints written, 0 kernel launches.  Then, on the model cut to 2
    decoder layers and 2 ViT blocks: the loss and LoRA gradients on the
    card against the port's own CPU run (a label shift must fail), remat
    on and off bit-identical, 4 micro-steps against 2 + preempt + 2
    resumed bit-identical, a non-finite loss moving nothing, and the
    evaluate CLI with ``--checkpoint`` through a JSON config;
18. videollama, the second backbone: (a) both kernels at its shapes:
    flash at the EVA-ViT-g + Vicuna model's prefill (4 clips, 1148
    tokens, left-padded prompts) and at the 2.1-AV model's (1 clip, 11123
    tokens, 28 query heads over 4 KV heads), under the flash rule and its
    controls; the GEMV at the 2.1-AV decode's five bf16 shapes (Qwen2's
    projections and its 152064-wide lm_head at M = 1), bit-identical
    across launch settings and to ``decode_gemv_in_order``; each timed
    beside bound and library call; (b) the evaluate CLI with ``--model
    VideoLLaMA`` at full width (``CUT_LAYERS`` decoder layers) in the
    default configuration on 5 synthetic QVH clips at batch 4 (0 launches), and its first batch
    again under ``--profile-dir`` (16 tokens); (c) the model in process in the slice
    routes: 32 flash and 224 GEMV launches per pass, ``lookup_spec=4``
    giving greedy's tokens, the first-step logits against the default
    routes; (d) the published VideoLLaMA2.1-AV architecture (SigLIP-
    so400m, Qwen2-7B in bf16, BEATs) seeded at full width and depth on one
    clip in the slice routes: 28 flash and 197 GEMV launches per pass, its
    first-step logits held against the default routes; (e) the finetune
    CLI with ``--model VideoLLaMA`` as in 17: finite losses, the LoRA B,
    connector and audio projector leaves moved, no frozen leaf changed, 0
    launches.

19. quant, the quantized formats and the single-chip memory levers (no
    new kernel: the JAX package computes them in XLA): (a) ``quant_slice``,
    the slice model at full width and depth with the int4 KV cache and
    the ``scan_layers`` layout on the 3 clips (16 greedy tokens): 32 flash
    and 224 GEMV launches per pass; the same weights through the stacked
    names into a per-layer decoder give the same tokens bit for bit; the
    int8 cache's first-step logits against the int4 cache's; one layer's
    decode attention over both caches, timed; (b) ``quant_int4``, the
    evaluate CLI at full width with a JSON config of int4 weights and the
    int4 cache, ``--quant-encoders``, the default routes and grammar
    decoding on 3 clips at batch 3: 0 launches, 0 invalid predictions, the
    weight bytes by part and the peak memory; (c) ``quant_w8a8``,
    ``int8_dot`` at full width (``CUT_LAYERS`` decoder layers) in the
    default routes: 0 launches, each
    row's greedy tokens alone equal to its tokens in the 3-row batch, one
    layer's projections through W8A8, the XLA route and the GEMV; (d)
    ``quant_serve``, the engine over the int4 cache with ``kv_keep`` 1784
    in the 8-layer serving model: the offline decoder's tokens; (e)
    ``single_chip``, the finetune CLI with ``--single-chip`` at full width
    and depth (4 micro-steps at batch 2 in one encoder window, validation
    on 1 clip): finite losses, the stacked LoRA B moved, no encoder leaf
    on the card during a loss step, 0 launches, seconds per micro-step,
    MFU, the loss steps' peak memory; (f) on the narrow model,
    ``encoder_window=2`` with ``upload_overlap`` against the per-batch
    split, bit for bit.

20. parallel, one process per card over NCCL on every visible card up to
    4: the evaluate CLI under ``torch.distributed.run`` on a cards x 1
    mesh (one card: a 1 x 1 mesh through a real NCCL group) at full
    width, 8 decoder layers, in the slice configuration, for both
    backbones (``--model VideoLLaMA`` too): both kernels launched on every
    rank, the JSONL equal to the same CLI's without a mesh.  With 4 cards
    also: model = 4 generate at full width and depth on the 3 clips
    against the same on one card (the first-step logits within
    ``TP_LOGIT_REL_L2``, the tokens compared and the first differing
    position reported; with ``seq_shard`` too), grammar decoding at
    ``spec_width`` 4 and 1 giving identical tokens on the model axis; the
    published 2.1-AV decoder at full width and depth on a 1 x 4 mesh on
    one clip against one card (7 query heads over 1 KV head per rank, 28
    flash and 197 GEMV launches per rank per prefill and pass, the
    first-step logits within ``TP_LOGIT_REL_L2``); and the finetune CLI
    on a 2 x 2 mesh (8 layers, 4 micro-steps at a global batch of 2) for
    both backbones against one card's losses, VideoLLaMA's connector and
    audio projector moved and equal on every rank; per-rank peak memory
    and seconds.

``--only`` runs the named groups of phases (kernels: 3; models: 4-9;
evaluate: 10-11; serve: 12-15; converted: 16; train: 17; videollama: 18; quant: 19;
parallel: 20;
spec_width: the probe of
the serving engine at ``spec_width`` 20 against 1, ROADMAP C.2, which a
full run leaves out) after the build, for debugging; such a run prints
no summary and no ``ok`` line.

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
import os
import resource
import shutil
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
# the decoder depth of the full-width runs cut to half depth to pay, in the
# script's time, for the phases added since: the serve CLI (12, 14), the
# finetune CLI (17, 18e), VideoLLaMA's evaluate CLI (18b) and W8A8 (19c)
CUT_LAYERS = 16
# GEMV vs plain: 1 bf16 ulp + GEMV_SUM_ERR * sqrt(K) * 2^-24 * sum|x w| (the
# size of an f32 summation error; see gemv_identity)
GEMV_SUM_ERR = 4.0


# each phase's seconds, as emitted; ``--out`` writes them beside the results
PHASE_SECONDS: dict = {}


def emit(obj) -> None:
    if "phase" in obj and "seconds" in obj:
        PHASE_SECONDS[obj["phase"]] = obj["seconds"]
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


# the X-InstructBLIP prefix's masks: interior padding in its timestamp slots
# (row 1), left padding (row 2); the controls re-open the interior padding
# and close one kv tile
XIB_FLASH_MASK = (((1, slice(1000, 1040)), 0), ((2, slice(0, 17)), 0))
XIB_FLASH_CONTROLS = (("interior_padding_ignored", (1, slice(1000, 1040)), 1),
                      ("kv_tile_skipped", (2, slice(2944, 3072)), 0))


def check_flash(dev, b, h, s, kv, d, gen, holes=XIB_FLASH_MASK, controls=XIB_FLASH_CONTROLS,
                kv_from_heads: int = 0):
    """Flash at a prefill's shape against its plain version under the
    per-element rule, with two controls that must fail it; timed beside
    its bound and SDPA.  ``holes``: masked (row, columns) besides the
    unwritten cache columns and key 0 of row 0 (a fully masked query).
    ``kv_from_heads``: K and V come from that many KV heads repeated to
    ``h`` (grouped-query attention, as ``models/llama.py`` feeds them)."""
    from mraudio_tpu_torch.ops.attention import flash_attention, flash_attention_plain

    # the prefill's layout: (B, S, H, D) buffers read through transposed views
    q = torch.randn((b, s, h, d), generator=gen, device=dev).to(torch.bfloat16).transpose(1, 2)
    kvh = kv_from_heads or h
    k, v = (torch.randn((b, kv, kvh, d), generator=gen, device=dev).to(torch.bfloat16)
            .repeat_interleave(h // kvh, dim=2).transpose(1, 2) for _ in range(2))
    mask = torch.ones((b, kv), dtype=torch.int32, device=dev)
    mask[:, s:] = 0                 # cache columns the prefill has not written
    mask[0, 0] = 0                  # query row 0 of batch row 0: fully masked
    for cols, value in holes:
        mask[cols] = value
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
    controls_err = {}
    for name, cols, value in controls:
        bad_mask = mask.clone()
        bad_mask[cols] = value
        controls_err[name] = flash_excess(flash_attention(q, k, v, bad_mask, causal=True), ref)
        if not controls_err[name] > 1.0:
            raise AssertionError(f"flash check cannot tell {name}: {controls_err[name]} x its "
                                 "limit")

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
                controls_err_over_limit=controls_err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bms, bound_by=by,
                shape=dict(b=b, h=h, s=s, kv=kv, d=d, kv_heads=kvh), flops=flops,
                bytes=nbytes)


# tensor-parallel widths whose per-rank kernel shapes phase 3 checks
TP_WIDTHS = (2, 4)


def tp_gemv_shapes(m: int) -> list:
    """(K, N) of one decoder layer's int8 GEMVs on one of ``m`` model
    ranks, in ``layer()``'s order: q, k, v (columns: 4096 x 4096/m), o
    (rows: 4096/m x 4096), gate, up (columns: 4096 x 11008/m), down
    (rows: 11008/m x 4096).  The route is decided on the whole widths, so
    11008/4 = 2752, which the JAX package's tiling rule would refuse,
    still runs the kernel (K and N multiples of 8, N of 16 for int8)."""
    return [(4096, 4096 // m), (4096 // m, 4096), (4096, 11008 // m), (11008 // m, 4096)]


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


@torch.no_grad()
def seed_lora_b_(model, seed: int, std: float = 0.01) -> int:
    """Every LoRA B of ``model`` seeded N(0, ``std``) in its dtype (the
    seeded init leaves B zero, which hides the LoRA delta's bits);
    returns the count of LoRA targets."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    targets = [m for m in model.llm.modules() if getattr(m, "lora_scale", 0)]
    for m in targets:
        m.lora_b.copy_(torch.randn(m.lora_b.shape, generator=gen, device=model.device) * std)
    return len(targets)


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


# Decode steps of a traced generate: a trace's size and the time to write
# and read it grow with the steps (about 1.4 s per step of a 32-layer
# batch), and every greedy step of a random-weight model does the same work,
# so the traced runs decode this many tokens; their decode seconds are held
# against the unprofiled run's per-step time.
PROFILE_TOKENS = 16


def traced_unprofiled(stats: dict, steps: int = PROFILE_TOKENS) -> dict:
    """The unprofiled run's phase seconds with decode scaled to ``steps``."""
    return {"encode_s": stats["encode_s"], "prefill_s": stats["prefill_s"],
            "decode_s": stats["decode_s"] * steps / stats["decode_steps"]}


def profile_generate(model, batch, unprofiled: dict, top: int = 12) -> dict:
    """One more ``generate`` under ``torch.profiler``, decoding
    :data:`PROFILE_TOKENS` tokens, broken down by :func:`phase_breakdown`."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
            model_settings(model, max_new_tokens=PROFILE_TOKENS):
        model.generate(batch=batch, stats={})
    trace = Path(__file__).resolve().parent / "build" / "profile" / "generate_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    return dict(decode_tokens_traced=PROFILE_TOKENS,
                **phase_breakdown(trace, traced_unprofiled(unprofiled), top))


def phase_breakdown(trace: Path, unprofiled: dict | None, top: int = 12,
                    names=("encode", "prefill", "decode")) -> dict:
    """Read (and delete) a chrome trace of one ``generate``.  For each phase
    span (``names``: ``encode``, ``prefill``, ``decode``) on the host: the device time
    of every kernel launched inside it, the union of those intervals
    (busy), and the idle share ``1 - busy / span``.  The profiler slows the
    host, so the idle share is also given against the unprofiled run's
    phase seconds (``unprofiled[f"{phase}_s"]``), where there is one."""
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
        vs = {}
        if unprofiled is not None:
            vs = dict(unprofiled_ms=unprofiled[f"{phase}_s"] * 1e3,
                      idle_share_vs_unprofiled=1 - busy / 1e3 / (unprofiled[f"{phase}_s"] * 1e3))
        phases[phase] = dict(
            span_ms=(t1 - t0) / 1e3, device_busy_ms=busy / 1e3, idle_share=1 - busy / (t1 - t0),
            **vs, kernel_names=len(per_name),
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
    lora_targets = seed_lora_b_(model, seed)
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
        lora_targets_nonzero_b=lora_targets,
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
    if not bool(torch.isfinite(stats["prefill_logits"][:, :model.llm.cfg.vocab_size]).all()):
        raise AssertionError(f"{changes}: non-finite prefill logits")
    return dict(tokens=tokens, texts=texts, launches=launches, passes=passes,
                committed_tokens=stats.get("decode_tokens"), prefill_s=stats["prefill_s"],
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


def cut_config(path: Path, **model_changes) -> list:
    """``--config`` arguments naming a JSON RunConfig of what ``--model-size
    full`` builds (``full_model_config()`` on the QVH data config) with the
    decoder cut to :data:`CUT_LAYERS` and ``model_changes``, written to
    ``path``."""
    from mraudio_tpu_torch.config import DataConfig, RunConfig, full_model_config

    full = full_model_config()
    model = full.replace(llm=full.llm.replace(num_layers=CUT_LAYERS), **model_changes)
    path.write_text(json.dumps(RunConfig(model=model,
                                         data=DataConfig.for_dataset("QVH")).to_dict()))
    return ["--config", str(path)]


def evaluate_cli(fast: bool = False, model: str = "X-InstructBLIP") -> dict:
    """The evaluate CLI in-process at full width in the deployed default
    configuration (``--model-size full``: chunked attention, XLA-route
    projections, ``prefill_chunk=2048``) on 5 synthetic QVH clips at batch
    3 (two batches, the second with a padding row), then the port's
    scorer on its JSONL.  The default configuration routes around both
    kernels: 0 launches of each are asserted.  ``fast`` adds ``--fast``
    (the yuv420 wire, the temporal-residual ViT, grammar decoding at
    ``spec_width=4``): then no prediction may be invalid.  ``model=
    "VideoLLaMA"`` runs ``--model VideoLLaMA`` at batch 4 (``bench.py``'s
    videollama profile; its 1148-token prefix is one prefill segment),
    the decoder cut to :data:`CUT_LAYERS`."""
    from mraudio_tpu_torch.cli import evaluate as cli
    from mraudio_tpu_torch.eval.mr_eval import eval_submission
    from mraudio_tpu_torch.eval.span_utils import load_jsonl
    from mraudio_tpu_torch.ops.attention import flash_attention
    from mraudio_tpu_torch.ops.gemv import decode_gemv

    videollama = model == "VideoLLaMA"
    name = "smoke_videollama" if videollama else ("smoke_fast" if fast else "smoke")
    root = Path(__file__).resolve().parent / "build" / name
    root.mkdir(parents=True, exist_ok=True)
    extra = (["--fast"] if fast else []) + ["--model", model]
    bs, segments = (VL_BATCH, 1) if videollama else (3, 3)
    anns = [{"vid": f"v{i}", "qid": i, "query": QUERIES[i % 3], "duration": 150,
             "relevant_windows": [[10.0 + 24 * i, 34.0 + 24 * i]]} for i in range(5)]
    gt, out = root / "annotations.jsonl", root / "predictions.jsonl"
    gt.write_text("".join(json.dumps(a) + "\n" for a in anns))
    out.unlink(missing_ok=True)

    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    decode_gemv.launches = 0
    t = time.perf_counter()
    size = cut_config(root / "config.json") if videollama else ["--model-size", "full"]
    result = cli.main(["--annotation-file", str(gt), "--output-file", str(out), *size,
                       "--video-source", "synthetic", "--batch-size", str(bs), *extra])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {"flash_attention": flash_attention.launches, "decode_gemv": decode_gemv.launches}
    if launches != {"flash_attention": 0, "decode_gemv": 0}:
        raise AssertionError(f"evaluate ({model}, default config{', --fast' if fast else ''}) "
                             f"launched kernels: {launches}")
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
    if len(batches) != 2 or any(bt["prefill_segments"] != segments for bt in batches):
        raise AssertionError(f"evaluate: batches {batches}")
    metrics = eval_submission(records, anns, verbose=False)
    if fast and metrics["brief"]["MR-full-invalid_pred_num"] != 0:
        raise AssertionError(f"fast evaluate: invalid predictions {metrics['brief']}")
    peak = torch.cuda.max_memory_allocated()

    # the first batch once more under --profile-dir: where its time goes
    # (without --fast, decoding PROFILE_TOKENS tokens: a config file with
    # that budget; grammar decoding ends its spans in fewer passes anyway)
    gt3 = root / "annotations_batch0.jsonl"
    gt3.write_text("".join(json.dumps(a) + "\n" for a in anns[:bs]))
    unprofiled = batches[0]
    if not fast:
        from mraudio_tpu_torch.config import DataConfig, RunConfig, full_model_config

        traced = root / "traced_config.json"
        if videollama:
            cut_config(traced, max_new_tokens=PROFILE_TOKENS)
        else:
            traced.write_text(json.dumps(RunConfig(
                model=full_model_config().replace(max_new_tokens=PROFILE_TOKENS),
                data=DataConfig.for_dataset("QVH")).to_dict()))
        size, unprofiled = ["--config", str(traced)], traced_unprofiled(batches[0])
    cli.main(["--annotation-file", str(gt3), "--output-file", str(root / "profiled.jsonl"),
              *size, "--video-source", "synthetic", "--batch-size", str(bs),
              "--profile-dir", str(root / "profile"), *extra])
    breakdown = phase_breakdown(root / "profile" / "trace.json", unprofiled)
    breakdown["decode_tokens_traced"] = 64 if fast else PROFILE_TOKENS
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
    configuration, the decoder cut to :data:`CUT_LAYERS` (no kernel: 0
    launches asserted) on ``n`` synthetic QVH requests; its records
    checked, its stats line and the peak memory returned."""
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
                      *cut_config(root / "config.json"), "--video-source", "synthetic", *extra])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = read_launches()
    if launches != {"flash_attention": 0, "decode_gemv": 0}:
        raise AssertionError(f"{name}: the default configuration launched kernels: {launches}")
    records = load_jsonl(str(out))
    check_records(records, n, name)
    if stats["requests"] != n:
        raise AssertionError(f"{name}: stats {stats}")
    return dict(layers=CUT_LAYERS, stats=stats, launches=launches,
                peak_mem_bytes=torch.cuda.max_memory_allocated(),
                wall_s_with_model_build=wall, raw_out=[r["raw_out"] for r in records])


def drive_engine(engine, requests: list, cancel_id=None, trace: bool = False):
    """Run ``requests`` through the engine, admitting what fits whenever a
    slot is free; ``cancel_id`` is cancelled after its first token.
    Returns ``(tokens by request id, decode dispatches, seconds)``."""
    from mraudio_tpu_torch.utils.profiling import annotate

    pending, results, dispatches = list(requests), {}, 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    with annotate("engine") if trace else contextlib.nullcontext():
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


# decoder layers of the in-process serving model (phases 13-15): the depth
# cut that pays for phase 16; every check holds at any depth
SERVE_LAYERS = 8


def serve_model(dev, layers: int = SERVE_LAYERS):
    """The deployed default configuration in-process at full width, cut to
    ``layers`` decoder layers, random weights from ``train.seed`` with LoRA
    B seeded non-zero, and 4 synthetic QVH requests encoded up front
    (device-resident prefixes)."""
    from mraudio_tpu_torch.cli.serve import encode_requests
    from mraudio_tpu_torch.config import DataConfig, RunConfig, full_model_config
    from mraudio_tpu_torch.data.dataset import MRDataset
    from mraudio_tpu_torch.infer.evaluate import build_model as build_run_model
    from mraudio_tpu_torch.models.casting import cast_params_for_inference

    full = full_model_config()
    cfg = RunConfig(model=full.replace(llm=full.llm.replace(num_layers=layers)),
                    data=DataConfig.for_dataset("QVH", video_source="synthetic"))
    model = cast_params_for_inference(build_run_model(cfg, dev))
    seed_lora_b_(model, cfg.train.seed)
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
    projections, one-shot prefill), greedy and at ``spec_width`` 4: a
    flash launch per layer and admission and 7 GEMV launches per layer and
    dispatch (M = 4 slots, or 4 x 4 rows in a verify pass), and identical
    tokens."""
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


def spec_width_probe(model, requests, width: int = 20) -> dict:
    """ROADMAP C.2 on the card: the engine at ``spec_width`` ``width``, its
    limit and slot slack widened to ``max(16, width)``, against
    ``spec_width`` 1, the same requests.  A reading, not a check: the
    engine refuses ``spec_width`` > 16 unless this keeps the tokens."""
    import mraudio_tpu_torch.infer.serving as serving

    llm, eos = model.llm, model.llm_tokenizer.eos_token_id
    reqs = [r for r, _ in requests[:3]]
    s = reqs[0].prefix_embeds.shape[0]
    runs = {}
    slack = serving.MAX_SPEC_WIDTH
    for w in (1, width):
        serving.MAX_SPEC_WIDTH = max(slack, w)
        try:
            engine = serving.ContinuousBatcher(llm, s, model.cfg.max_new_tokens, eos,
                                               max_slots=4, spec_width=w)
        finally:
            serving.MAX_SPEC_WIDTH = slack
        tokens, dispatches, secs = drive_engine(engine, reqs)
        engine.close()
        runs[w] = dict(tokens=tokens, dispatches=dispatches, seconds=secs)
    first_diff = {}
    for rid, want in runs[1]["tokens"].items():
        got = runs[width]["tokens"][rid]
        first_diff[rid] = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                               None if len(got) == len(want) else min(len(got), len(want)))
    return dict(spec_width=width, slack=max(slack, width), layers=llm.cfg.num_layers,
                tokens_identical=all(v is None for v in first_diff.values()),
                first_differing_token=first_diff,
                dispatches={w: r["dispatches"] for w, r in runs.items()},
                seconds={w: r["seconds"] for w, r in runs.items()})


# --------------------------------------------------------------------------
# Phase 16: converted weights
# --------------------------------------------------------------------------

# the depth cut of the fabricated checkpoints: f32 files of the whole 7B
# model would take ~31 GB and most of the time limit
CONVERTED_LAYERS = {"llm decoder layers": 2, "EVA-ViT-g blocks": 2}


def converted_config(**weights):
    """``full_model_config()`` at full width with the depth cut, the QVH
    data configuration with synthetic video, and ``weights`` (RunConfig
    weight fields)."""
    from mraudio_tpu_torch.config import DataConfig, RunConfig, full_model_config

    m = full_model_config()
    m = m.replace(llm=m.llm.replace(num_layers=CONVERTED_LAYERS["llm decoder layers"]),
                  vit=m.vit.replace(depth=CONVERTED_LAYERS["EVA-ViT-g blocks"]))
    return RunConfig(model=m, data=DataConfig.for_dataset("QVH", video_source="synthetic"),
                     **weights)


def _host_peak_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def converted(dev) -> dict:
    """Phase 16 under ``build/converted``, deleted at the end."""
    root = Path(__file__).resolve().parent / "build" / "converted"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        return _converted(dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _converted(dev, root: Path) -> dict:
    from mraudio_tpu_torch.cli import convert, parity
    from mraudio_tpu_torch.cli import evaluate as cli_evaluate
    from mraudio_tpu_torch.cli import serve as cli_serve
    from mraudio_tpu_torch.eval.span_utils import load_jsonl
    from mraudio_tpu_torch.models.casting import cast_params_for_inference
    from mraudio_tpu_torch.models.convert_weights import WEIGHT_FIELDS, load_pretrained_params
    from mraudio_tpu_torch.models.fabricate import fabricate_checkpoint_dir
    from mraudio_tpu_torch.models.factory import build_model as build_backbone

    steps = {}

    def step(name, t0, nbytes):
        torch.cuda.synchronize()
        steps[name] = dict(host_s=time.perf_counter() - t0, bytes=nbytes,
                           host_peak_rss_gb=_host_peak_gb())

    bare = converted_config()
    t = time.perf_counter()
    paths = fabricate_checkpoint_dir(bare.model, str(root / "ckpt"), seed=0)
    step("fabricate", t, sum(os.path.getsize(p) for p in paths.values()))
    cfg = converted_config(**{WEIGHT_FIELDS[r]: p for r, p in paths.items()})

    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = load_pretrained_params(build_backbone(cfg, dev), cfg)
    step("load_convert_quantize", t, steps["fabricate"]["bytes"])
    n_params = sum(p.numel() for p in model.parameters())
    t = time.perf_counter()
    store = convert.save_param_store(str(root / "store.pt"), model, convert.store_meta(cfg))
    step("store_save", t, os.path.getsize(store))
    t = time.perf_counter()
    from_store = convert.resolve_params(build_backbone(bare, dev), bare, store)
    step("store_load", t, os.path.getsize(store))
    compared = 0
    for (name, p), (name2, q) in zip(model.named_parameters(), from_store.named_parameters()):
        if name != name2 or p.dtype != q.dtype or not torch.equal(p, q):
            raise AssertionError(f"converted: {name} from the store differs from the checkpoints'")
        compared += 1
    del from_store

    # the GEMV on one converted layer's quantize_llama_int8 weights
    gen = torch.Generator(device=dev).manual_seed(6)
    layer0 = model.llm.layers[0]
    gemv = {}
    for name, proj in (("q_proj", layer0.attn.q_proj), ("gate_proj", layer0.mlp.gate_proj),
                       ("down_proj", layer0.mlp.down_proj)):
        if not bool((proj.w_int8.abs().amax(dim=0) == 127).all()):
            raise AssertionError(f"converted {name}: a column's absmax is not 127")
        x = torch.randn((3, proj.in_features), generator=gen, device=dev).to(torch.bfloat16)
        gemv[name] = gemv_identity(x, proj.w_int8, proj.scale, f"converted layer 0 {name}")

    # the slice configuration's generate on the converted model
    cast_params_for_inference(model)
    batch = qvh_batch(3, bare.data.n_frms, bare.model.vit.image_size,
                      bare.data.audio.max_audio_seconds, bare.data.audio.sampling_rate, seed=1)
    with llm_settings(model, attention_impl="pallas", decode_gemv="pallas", prefill_chunk=0):
        generate = run_decoder(model, batch)
    generate = dict(_summary(generate), peak_mem_bytes=torch.cuda.max_memory_allocated())
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # the evaluate CLI from the checkpoints, then from the store
    with_paths, without = root / "config_checkpoints.json", root / "config_store.json"
    with_paths.write_text(json.dumps(converted_config(**{
        WEIGHT_FIELDS[r]: paths[r] for r in ("vit", "video_qformer", "audio_qformer", "blip2")
    }).to_dict()))
    without.write_text(json.dumps(bare.to_dict()))
    anns = [{"vid": f"v{i}", "qid": i, "query": QUERIES[i % 3], "duration": 150,
             "relevant_windows": [[10.0 + 24 * i, 34.0 + 24 * i]]} for i in range(5)]
    gt = root / "annotations.jsonl"
    gt.write_text("".join(json.dumps(a) + "\n" for a in anns))
    evaluate = {}
    for name, extra in (("checkpoints", ["--config", str(with_paths), "--model-path", paths["llm"],
                                         "--audio-encoder", paths["beats"]]),
                        ("store", ["--config", str(without), "--params-store", store])):
        set_launches(0)
        t = time.perf_counter()
        result = cli_evaluate.main(["--annotation-file", str(gt), "--output-file",
                                    str(root / f"{name}.jsonl"), "--batch-size", "3",
                                    "--video-source", "synthetic", *extra])
        torch.cuda.synchronize()
        evaluate[name] = dict(wall_s_with_load=time.perf_counter() - t,
                              clips_per_sec=result["clips_per_sec"], launches=read_launches())
        if evaluate[name]["launches"] != {"flash_attention": 0, "decode_gemv": 0}:
            raise AssertionError(f"converted evaluate ({name}) launched kernels")
        if [r["qid"] for r in result["records"]] != list(range(5)):
            raise AssertionError(f"converted evaluate ({name}): {len(result['records'])} records")
    if (root / "checkpoints.jsonl").read_bytes() != (root / "store.jsonl").read_bytes():
        raise AssertionError("converted evaluate: the store's predictions differ from the "
                             "checkpoints'")
    gc.collect()
    torch.cuda.empty_cache()

    # the serve CLI from the store
    ann4 = root / "serve.jsonl"
    ann4.write_text("".join(json.dumps(a) + "\n" for a in serve_annotations(4)))
    set_launches(0)
    t = time.perf_counter()
    serve_stats = cli_serve.main(["--annotation-file", str(ann4), "--output-file",
                                  str(root / "served.jsonl"), "--config", str(without),
                                  "--params-store", store, "--video-source", "synthetic"])
    torch.cuda.synchronize()
    serve = dict(stats=serve_stats, wall_s_with_load=time.perf_counter() - t,
                 launches=read_launches())
    if serve["launches"] != {"flash_attention": 0, "decode_gemv": 0}:
        raise AssertionError("converted serve launched kernels")
    check_records(load_jsonl(str(root / "served.jsonl")), 4, "converted serve")
    gc.collect()
    torch.cuda.empty_cache()

    # the parity CLI at tiny size on the card: alone, then against itself
    tiny_gt = root / "parity_annotations.jsonl"
    tiny_gt.write_text("".join(json.dumps(a) + "\n" for a in anns[:3]))
    common = ["--model-size", "tiny", "--annotation", str(tiny_gt), "--video-source",
              "synthetic", "--num-workers", "1"]
    first = parity.main(["--fabricate", "--output-dir", str(root / "parity1"), *common])
    second = parity.main(["--ckpt-dir", str(root / "parity1" / "fabricated"), "--output-dir",
                          str(root / "parity2"), "--reference-jsonl",
                          str(root / "parity1" / "predictions.jsonl"), *common])
    if first["pass"] is not None or second["pass"] is not True \
            or second["span_diff"]["mismatched"] != 0:
        raise AssertionError(f"parity: {first['pass']} alone, {second['pass']} against itself")

    return dict(depth_cuts=CONVERTED_LAYERS, params=n_params, parameters_compared=compared,
                store_equals_checkpoints=True, steps=steps, gemv_converted_layer0=gemv,
                generate=generate, evaluate=evaluate, evaluate_jsonl_identical=True,
                serve=serve, parity=dict(alone=first["pass"], against_itself=second["pass"],
                                         span_mismatches=second["span_diff"]["mismatched"]),
                host_peak_rss_gb=_host_peak_gb())


# --------------------------------------------------------------------------
# Phase 17: training
# --------------------------------------------------------------------------

TRAIN_CLIPS, VAL_CLIPS, TRAIN_BATCH = 8, 2, 2

# the finetune subprocess: runs the CLI's main with every micro-step timed
# (synchronised), the fourth traced, and prints one JSON line of readings
_FINETUNE_RUNNER = r"""
import json, sys, time
import torch
import chip_smoke
from mraudio_tpu_torch.cli import finetune
from mraudio_tpu_torch.train import trainer as trainer_mod
from torch.profiler import ProfilerActivity, profile

out = {"step_s": [], "seq_len": None}
real = trainer_mod.Trainer.train_step
trace = chip_smoke.Path(chip_smoke.__file__).resolve().parent / "build" / "profile" / "train_trace.json"

def timed(self, batch):
    m = self.model
    if out["seq_len"] is None:
        n = batch.timestamps.shape[1]
        if hasattr(m, "prepare_text"):
            text = m.prepare_text(batch.text_input, batch.timestamps, batch.duration,
                                  text_output=batch.text_output)
            out["seq_len"] = int(m.prefix_mask_host(text, n).shape[1]
                                 - text.prompt_mask.shape[1] + text.concat_ids.shape[1])
        else:   # VideoLLaMA: the connector's and the audio tokens, prompt + target
            out["seq_len"] = chip_smoke.vl_prefix_len(m.cfg, n) + m.cfg.max_output_txt_len
        out["n_frms"] = int(n)
    torch.cuda.synchronize()
    t = time.perf_counter()
    if len(out["step_s"]) == 3:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            loss = real(self, batch)
            torch.cuda.synchronize()
        out["step_s"].append(time.perf_counter() - t)
        trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace))
        spans = ("encode",) * self.split_encode + ("loss_fwd_bwd", "optimizer")
        out["profile_step4"] = chip_smoke.phase_breakdown(trace, None, names=spans)
    else:
        loss = real(self, batch)
        torch.cuda.synchronize()
        out["step_s"].append(time.perf_counter() - t)
    out["train_peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    return loss

real_train = trainer_mod.Trainer.train

def digests(params):
    return [(float(p.detach().double().sum()), float(p.detach().double().abs().sum()))
            for p in params]

def checked_train(self):
    # the run, with every frozen leaf's digest (f64 sum and sum of |x|)
    # taken before and after it, and each trainable leaf compared
    trained = {id(p) for p in self.trainable.values()}
    frozen = [p for p in self.model.parameters() if id(p) not in trained]
    before, start = digests(frozen), {k: p.detach().clone() for k, p in self.trainable.items()}
    summary = real_train(self)
    out["frozen_leaves"] = len(frozen)
    out["frozen_changed"] = sum(a != b for a, b in zip(before, digests(frozen)))
    moved = {}
    for k, p in self.trainable.items():
        group = k.split("/")[-1] if k.startswith("llm/") else k.split("/")[0]
        n, total = moved.get(group, (0, 0))
        moved[group] = (n + int(not torch.equal(p.detach(), start[k])), total + 1)
    out["trainable_moved"] = moved
    return summary

trainer_mod.Trainer.train_step = timed
trainer_mod.Trainer.train = checked_train
chip_smoke.set_launches(0)
t = time.perf_counter()
summary = finetune.main(sys.argv[1:])
torch.cuda.synchronize()
out["wall_s"] = time.perf_counter() - t
out["launches"] = chip_smoke.read_launches()
out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
out["summary"] = {k: v for k, v in summary.items() if k != "results"}
print("FINETUNE " + json.dumps(out), flush=True)
"""


def train_annotations(n: int, start: int = 0) -> list:
    return [{"vid": f"t{i}", "qid": i, "query": QUERIES[i % 3], "duration": 150,
             "relevant_windows": [[float(10 + 13 * i), float(30 + 13 * i)]]}
            for i in range(start, start + n)]


def finetune_cli(model: str = "X-InstructBLIP") -> dict:
    """The finetune CLI in a process of its own at full width in its
    default full configuration, the decoder cut to :data:`CUT_LAYERS`
    through a ``--config`` (int8 Vicuna-7B, LoRA r 8 on the seven
    projections, block remat, AdamW under 2 accumulation steps, crops,
    the nan guard): 8 synthetic QVH clips at batch 2 (4 micro-steps, 2
    updates), 1 epoch, validation on 2 clips.  Every loss must be finite,
    every LoRA B (zero at init) non-zero after the run, no frozen leaf
    changed, ``checkpoint_0`` and its sidecar written, ``checkpoint_best``
    too exactly when the val MR-full-R1-avg beat 0 (the JAX trainer's
    rule: random weights rarely give a window that scores), and neither
    kernel launched.  ``model="VideoLLaMA"`` trains the second backbone
    (``--model VideoLLaMA``), whose connector and audio projector leaves
    must move too.  The readings are printed before the checks."""
    from mraudio_tpu_torch.config import (AudioFrontendConfig, DATASET_MAX_AUDIO_SECONDS,
                                          DataConfig, RunConfig, full_model_config)
    from mraudio_tpu_torch.train.checkpoint import load_checkpoint
    from mraudio_tpu_torch.utils.flops import peak_flops_for, train_step_flops

    full = full_model_config()
    # the CLI's --model-size full with the decoder cut
    model_cfg = full.replace(vit=full.vit.replace(grad_checkpoint=True),
                             llm=full.llm.replace(grad_checkpoint=True, num_layers=CUT_LAYERS))
    videollama = model == "VideoLLaMA"
    root = Path(__file__).resolve().parent / "build" / f"smoke_train_{model}"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    train_ann, val_ann, out = root / "train.jsonl", root / "val.jsonl", root / "out"
    train_ann.write_text("".join(json.dumps(a) + "\n" for a in train_annotations(TRAIN_CLIPS)))
    val_ann.write_text("".join(json.dumps(a) + "\n"
                               for a in train_annotations(VAL_CLIPS, TRAIN_CLIPS)))
    config = root / "config.json"
    config.write_text(json.dumps(RunConfig(model=model_cfg,
                                           data=DataConfig.for_dataset("QVH")).to_dict()))
    args = ["--config", str(config), "--video-source", "synthetic", "--batch-size",
            str(TRAIN_BATCH), "--max-epoch", "1", "--save-freq", "1",
            "--train-annotation-file", str(train_ann), "--val-annotation-file", str(val_ann),
            "--output-dir", str(out), "--model", model]
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _FINETUNE_RUNNER, *args],
                          cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                          timeout=900)
    wall = time.perf_counter() - t
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("FINETUNE ")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"finetune CLI failed ({proc.returncode}): "
                             f"{proc.stderr[-3000:]}")
    run = json.loads(lines[-1][len("FINETUNE "):])
    events = [json.loads(ln) for ln in (out / "train.jsonl").read_text().splitlines()]
    losses = [e["loss"] for e in events if e["event"] == "train_step"]
    val = [e for e in events if e["event"] == "val"]
    step_s = run["step_s"]
    median_s = float(np.median(step_s[1:4]))
    audio_cfg = AudioFrontendConfig(max_audio_seconds=DATASET_MAX_AUDIO_SECONDS["QVH"])
    if videollama:
        from mraudio_tpu_torch.models.videollama import videollama_config_from

        flops = vl_train_step_flops(videollama_config_from(model_cfg, run["n_frms"]),
                                    audio_cfg, run["n_frms"], TRAIN_BATCH, run["seq_len"])
    else:
        flops = train_step_flops(model_cfg, audio_cfg, run["n_frms"], TRAIN_BATCH,
                                 run["seq_len"], grad_checkpoint=True)
    peak = peak_flops_for(torch.cuda.get_device_name(0))
    trained = load_checkpoint(str(out / "checkpoint_0"))["model"]
    lora_b = {k: v for k, v in trained.items() if k.endswith("lora_b")}
    moved = sum(bool(v.abs().amax() > 0) for v in lora_b.values())
    best = run["summary"]["best_metric"] > 0
    result = dict(layers=CUT_LAYERS, subprocess_wall_s=wall, cli_wall_s=run["wall_s"],
                  losses=losses,
                  step_s=step_s, s_per_micro_step_median_2_4=median_s,
                  train_clips_per_s=TRAIN_BATCH / median_s, seq_len=run["seq_len"],
                  n_frms=run["n_frms"], train_step_flops=flops,
                  train_mfu=flops["total"] / (median_s * peak),
                  train_peak_mem_bytes=run["train_peak_mem_bytes"],
                  peak_mem_bytes=run["peak_mem_bytes"], val=val, lora_b_moved=moved,
                  lora_b_leaves=len(lora_b), checkpoint_best_written=(out / "checkpoint_best")
                  .is_file(), launches=run["launches"], profile_step4=run["profile_step4"],
                  summary=run["summary"], trainable_moved=run["trainable_moved"],
                  frozen_leaves=run["frozen_leaves"], frozen_changed=run["frozen_changed"])
    emit({"phase": "finetune_readings", **result})
    if len(losses) != TRAIN_CLIPS // TRAIN_BATCH or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"finetune: losses {losses}")
    if run["launches"] != {"flash_attention": 0, "decode_gemv": 0}:
        raise AssertionError(f"finetune launched kernels: {run['launches']}")
    if len(lora_b) != 7 * CUT_LAYERS or moved != len(lora_b):
        raise AssertionError(f"finetune: {moved} of {len(lora_b)} LoRA B leaves moved")
    if run["frozen_changed"] or not run["frozen_leaves"]:
        raise AssertionError(f"finetune: {run['frozen_changed']} of {run['frozen_leaves']} "
                             "frozen leaves changed")
    groups = ("lora_b", "connector", "audio_proj") if videollama else ("lora_b",)
    if sorted(run["trainable_moved"]) != sorted(("lora_a",) + groups) or any(
            run["trainable_moved"][g][0] != run["trainable_moved"][g][1] for g in groups):
        raise AssertionError(f"finetune: trainable leaves moved {run['trainable_moved']}")
    names = ["checkpoint_0"] + (["checkpoint_best"] if best else [])
    for name in names:
        if not (out / name).is_file() or not (out / (name + ".meta.json")).is_file():
            raise AssertionError(f"finetune: {name} or its sidecar is missing")
    if (out / "checkpoint_best").exists() != best:
        raise AssertionError(f"finetune: checkpoint_best written with best metric "
                             f"{run['summary']['best_metric']}")
    shutil.rmtree(root, ignore_errors=True)
    return result


# card (bf16) vs CPU (f32) on one micro-batch: bf16 activations round at
# 2^-9 per op through 2 decoder layers and the encoders, so the loss is
# held at 1% and each LoRA leaf's gradient at 10% of its norm (the
# relative L2 error); a label shift by one must break both
TRAIN_LOSS_RTOL = 1e-2
TRAIN_GRAD_REL_L2 = 0.10
IDENT_FRAMES = 8


def identities_config(dev_dtype: str = "bfloat16", **train):
    """The full-width model cut to the ``converted`` depth (2 decoder
    layers, 2 ViT blocks) with the finetune CLI's remat, 8 frames per clip,
    synthetic QVH data."""
    from mraudio_tpu_torch.config import DataConfig, RunConfig, TrainConfig, full_model_config

    m = full_model_config()
    m = m.replace(llm=m.llm.replace(num_layers=CONVERTED_LAYERS["llm decoder layers"],
                                    grad_checkpoint=True, dtype=dev_dtype),
                  vit=m.vit.replace(depth=CONVERTED_LAYERS["EVA-ViT-g blocks"],
                                    grad_checkpoint=True, dtype=dev_dtype),
                  beats=m.beats.replace(dtype=dev_dtype), qformer=m.qformer.replace(dtype=dev_dtype))
    data = DataConfig.for_dataset("QVH", video_source="synthetic").replace(n_frms=IDENT_FRAMES)
    return RunConfig(model=m, data=data, train=TrainConfig(**train))


def _loss_and_grads(trainer, batch, labels_shift: int = 0, dropout: bool = True):
    """One micro-batch's loss and LoRA gradients through the trainer's
    path (crop of step 0, dropout key of step 0 unless ``dropout`` is
    off: the card's and the CPU's generators draw other masks from one
    seed), without an update."""
    model = trainer.model
    arrays = list(model.device_arrays(model.loss_arrays(batch)))
    if labels_shift:
        arrays[10] = torch.roll(arrays[10], labels_shift, dims=1)
    crop = trainer._sample_crops(batch, step=0)
    key = trainer.dropout_key(0) if dropout and model.cfg.lora.dropout > 0 else None
    loss = model._loss_fn(*arrays, crop_params=crop, dropout_key=key,
                          n_frms=int(batch.timestamps.shape[1]))
    grads = torch.autograd.grad(loss, list(trainer.trainable.values()))
    return loss.detach().float().cpu(), {k: g.float().cpu()
                                         for k, g in zip(trainer.trainable, grads)}


def _rel_l2(a: dict, b: dict) -> float:
    return max(float((a[k] - b[k]).norm() / b[k].norm().clamp_min(1e-30)) for k in b)


def _state(trainer) -> dict:
    out = {f"leaf/{k}": p.detach().clone() for k, p in trainer.trainable.items()}
    out.update({k: v.clone() for k, v in trainer.opt.state_dict().items()})
    return out


def train_identities(dev) -> dict:
    """Phase 17b under ``build/smoke_train_id``, deleted at the end."""
    root = Path(__file__).resolve().parent / "build" / "smoke_train_id"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        return _train_identities(dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _train_identities(dev, root: Path) -> dict:
    from mraudio_tpu_torch.cli import evaluate as cli_evaluate
    from mraudio_tpu_torch.data.dataset import BatchLoader, MRDataset
    from mraudio_tpu_torch.infer.evaluate import build_model as build_trained
    from mraudio_tpu_torch.train import trainer as trainer_mod
    from mraudio_tpu_torch.train.checkpoint import load_checkpoint

    anns = train_annotations(4)
    val = train_annotations(1, 4)
    train_ann, val_ann = root / "train.jsonl", root / "val.jsonl"
    train_ann.write_text("".join(json.dumps(a) + "\n" for a in anns))
    val_ann.write_text("".join(json.dumps(a) + "\n" for a in val))
    out = {}

    def config(name, dtype="bfloat16", **train):
        cfg = identities_config(dtype, batch_size=1, max_epoch=1, num_workers=1,
                                output_dir=str(root / name), **train)
        return cfg.replace(data=cfg.data.replace(train_annotation_file=str(train_ann),
                                                 val_annotation_file=str(val_ann)))

    # 1. card vs the port's CPU run on one micro-batch, from the same weights
    t = time.perf_counter()
    cfg = config("card")
    model = build_trained(cfg, dev)
    trainer = trainer_mod.Trainer(cfg, model=model, device=dev)
    batch = next(iter(BatchLoader(MRDataset(cfg.data, annotations=anns, split="train"), 1)))
    card_loss, card_grads = _loss_and_grads(trainer, batch, dropout=False)
    shifted_loss, shifted_grads = _loss_and_grads(trainer, batch, labels_shift=1, dropout=False)
    cpu_cfg = config("cpu", "float32")
    cpu_model = build_trained(cpu_cfg, "cpu")
    with torch.no_grad():      # the card's bf16-rounded frozen values, in f32
        card_params = dict(model.named_parameters())
        for name, p in cpu_model.named_parameters():
            p.data = card_params[name].detach().to("cpu", p.dtype if p.dtype == torch.int8
                                                     else torch.float32).clone()
    cpu_trainer = trainer_mod.Trainer(cpu_cfg, model=cpu_model, frozen_bf16=False, device="cpu")
    cpu_loss, cpu_grads = _loss_and_grads(cpu_trainer, batch, dropout=False)
    cpu_trainer._restore_sigterm()
    trainer._restore_sigterm()
    del cpu_trainer, cpu_model
    loss_rel = float((card_loss - cpu_loss).abs() / cpu_loss.abs())
    grad_rel = _rel_l2(card_grads, cpu_grads)
    ctl_loss = float((shifted_loss - cpu_loss).abs() / cpu_loss.abs())
    ctl_grad = _rel_l2(shifted_grads, cpu_grads)
    if not (loss_rel <= TRAIN_LOSS_RTOL and grad_rel <= TRAIN_GRAD_REL_L2):
        raise AssertionError(f"train card vs CPU: loss {loss_rel}, grads {grad_rel}")
    # (random weights predict near-uniform tokens, so the shifted labels'
    # loss may stay close; their gradients may not)
    if ctl_loss <= TRAIN_LOSS_RTOL and ctl_grad <= TRAIN_GRAD_REL_L2:
        raise AssertionError(f"train control (labels shifted) passed: {ctl_loss}, {ctl_grad}")
    out["card_vs_cpu"] = dict(loss_card=float(card_loss), loss_cpu=float(cpu_loss),
                              loss_rel=loss_rel, loss_rtol=TRAIN_LOSS_RTOL,
                              grad_rel_l2_max=grad_rel, grad_rel_l2_limit=TRAIN_GRAD_REL_L2,
                              control_loss_rel=ctl_loss, control_grad_rel_l2=ctl_grad,
                              seconds=time.perf_counter() - t)

    # 2. grad_checkpoint on vs off: the same bits (LoRA dropout on)
    remat_loss, remat_grads = _loss_and_grads(trainer, batch)
    with llm_settings(model, grad_checkpoint=False):
        plain_loss, plain_grads = _loss_and_grads(trainer, batch)
    if not (torch.equal(plain_loss, remat_loss)
            and all(torch.equal(plain_grads[k], remat_grads[k]) for k in remat_grads)):
        raise AssertionError("train: grad_checkpoint on and off differ")
    out["remat_bit_identical"] = True

    # 3. four micro-steps straight vs two, checkpoint_preempt, two more
    initial = {k: p.detach().clone() for k, p in trainer.trainable.items()}

    def fresh(name, **train):
        with torch.no_grad():
            for k, p in initial.items():
                dict(model.named_parameters())[
                    trainer_mod.torch_name(tuple(k.split("/")))].copy_(p)
        return trainer_mod.Trainer(config(name, **train), model=model, device=dev)

    t = time.perf_counter()
    straight = fresh("straight")
    straight.train()
    want = _state(straight)
    first = fresh("resume")
    real = first.train_step

    def stop_after_two(b):
        loss = real(b)
        if first.global_step + 1 == 2:
            first._preempt_requested = True
        return loss

    first.train_step = stop_after_two
    summary = first.train()
    if not summary.get("preempted"):
        raise AssertionError(f"train: no preempt ({summary})")
    second = fresh("resume", resume_ckpt_path=summary["preempt_ckpt"])
    second.train()
    got = _state(second)
    if sorted(got) != sorted(want) or not all(torch.equal(got[k], want[k]) for k in want):
        raise AssertionError("train: the resumed run differs from the straight run")
    out["resume_bit_identical"] = dict(leaves_and_state=len(want),
                                       seconds=time.perf_counter() - t)

    # 4. a non-finite loss leaves the leaves and the moments untouched
    guard = fresh("guard")
    guard._restore_sigterm()
    before = _state(guard)
    real_loss = model._loss_from_tokens
    model._loss_from_tokens = lambda *a, **k: real_loss(*a, **k) * float("nan")
    try:
        guard.train_step(batch)
    finally:
        model._loss_from_tokens = real_loss
    after = _state(guard)
    if not all(torch.equal(before[k], after[k]) for k in before
               if k.startswith(("leaf/", "mu/", "nu/", "acc/"))):
        raise AssertionError("train: a non-finite loss moved the leaves or moments")
    out["nan_guard_untouched"] = True

    # 5. the evaluate CLI with --checkpoint, through a JSON --config
    ckpt_path = str(root / "straight" / "checkpoint_0")
    saved = load_checkpoint(ckpt_path)["model"]
    del trainer, straight, first, second, guard, model
    gc.collect()
    torch.cuda.empty_cache()
    cfg_path = root / "config.json"
    cfg_path.write_text(json.dumps(config("eval").to_dict()))
    gt = root / "eval.jsonl"
    gt.write_text("".join(json.dumps(a) + "\n" for a in val + anns[:1]))
    loaded = {}
    real_load = cli_evaluate.load_trained

    def capture(m, path):
        real_load(m, path)
        names = dict(m.named_parameters())
        loaded.update({k: names[trainer_mod.torch_name(tuple(k.split("/")))].detach().cpu()
                       .clone() for k in saved})
        return m

    cli_evaluate.load_trained = capture
    set_launches(0)
    try:
        result = cli_evaluate.main(["--annotation-file", str(gt), "--output-file",
                                    str(root / "pred.jsonl"), "--config", str(cfg_path),
                                    "--checkpoint", ckpt_path, "--video-source", "synthetic",
                                    "--batch-size", "2", "--device", str(dev)])
    finally:
        cli_evaluate.load_trained = real_load
    if not all(torch.equal(loaded[k], saved[k]) for k in saved):
        raise AssertionError("evaluate --checkpoint: the LoRA leaves differ from the checkpoint's")
    if [r["qid"] for r in result["records"]] != [4, 0] or read_launches() != {
            "flash_attention": 0, "decode_gemv": 0}:
        raise AssertionError(f"evaluate --checkpoint: {result['records']}, {read_launches()}")
    out["evaluate_checkpoint"] = dict(records=len(result["records"]), leaves=len(saved),
                                      leaves_bit_identical=True, launches=read_launches())
    return out


# --------------------------------------------------------------------------
# Phase 18: VideoLLaMA, the second backbone
# --------------------------------------------------------------------------

VL_BATCH, VL_CLIPS = 4, 5          # bench.py's videollama profile: batch 4
# shorter queries for rows 1 and 3 of the in-process batch: their prompts
# (under 128 tokens) are left-padded, so the prefill meets masked keys
# between the audio tokens and the prompt
VL_SHORT_QUERIES = {1: "a dog runs", 3: "people dance"}
# first-step logits of the 2.1-AV model, slice routes (flash, GEMV, one-shot
# prefill) against the default routes (chunked_attention, XLA projections,
# 2048-token segments), as ||delta|| / ||default||: each layer's attention
# differs within the flash rule (2^-6 of a row's rms) and 28 layers carry it
AV21_LOGITS_REL_L2 = 0.10


def vl_prefix_len(cfg, n_frms: int) -> int:
    """VideoLLaMA's prefill length: the connector's tokens, one audio token
    per chunk, the prompt budget."""
    return ((n_frms // cfg.temporal_stride) * (cfg.vit.num_patches // cfg.spatial_pool ** 2)
            + n_frms + cfg.max_txt_len)


def vl_train_step_flops(cfg, audio_cfg, n_frms: int, batch: int, seq_len: int) -> dict:
    """Analytic FLOPs of one VideoLLaMA LoRA micro-step, counted as
    ``utils/flops.py::train_step_flops`` counts X-InstructBLIP's: the
    frozen towers forward; the trained connector and projector forward and
    backward (3x); the LLM forward, its block recompute and the backward
    through the activations (4x); the full-sequence lm_head 3x."""
    from mraudio_tpu_torch.utils.flops import videollama_flops

    f = videollama_flops(cfg, audio_cfg, n_frms, batch, seq_len, 0)
    llm = cfg.llm
    llm_fwd = f["prefill"] - batch * 2 * llm.hidden_size * llm.vocab_size
    lm_head = batch * 2 * seq_len * llm.hidden_size * llm.vocab_size * 3.0
    enc = f["vit"] + f["beats"] + 3.0 * f["connector"]
    return {"encoders": enc, "llm": 4.0 * llm_fwd, "lm_head": lm_head,
            "total": enc + 4.0 * llm_fwd + lm_head}


def _vl_prompt_holes(cfg, rows: int) -> tuple:
    """The masked interior columns of a VideoLLaMA prefill at batch ``rows``:
    the left padding of each row's prompt (rows 1 and 3 of the in-process
    batch take :data:`VL_SHORT_QUERIES`)."""
    from mraudio_tpu_torch.text.prompts import build_query_prompt
    from mraudio_tpu_torch.text.tokenizer import ByteTokenizer

    tok = ByteTokenizer(cfg.llm.vocab_size)
    p0 = vl_prefix_len(cfg, 60) - cfg.max_txt_len
    holes = []
    for r in range(rows):
        prompt = build_query_prompt(VL_SHORT_QUERIES.get(r, QUERIES[r % 3])).strip()
        pad = max(cfg.max_txt_len - len(tok.encode(prompt, add_special_tokens=True)), 0)
        if pad:
            holes.append(((r, slice(p0, p0 + pad)), 0))
    return tuple(holes)


def videollama_kernels(dev, gen) -> dict:
    """Both kernels at the VideoLLaMA shapes.  Flash: the EVA-ViT-g +
    Vicuna model's prefill (B = 4, 32 heads, S = 1148, interior padding
    where the short prompts are left-padded) and the 2.1-AV model's (B = 1,
    28 query heads over 4 KV heads repeated, S = 11123), under the flash
    rule and its two controls, timed beside bound and SDPA.  GEMV: the
    2.1-AV decode's five bf16 shapes at M = 1 (Qwen2's q/o, k/v, gate/up,
    down and the 152064-wide lm_head), bit-identical across launch settings
    and to ``decode_gemv_in_order``, within the plain rule; timed per Qwen2
    layer (7 launches) and for the lm_head."""
    from mraudio_tpu_torch.config import full_model_config
    from mraudio_tpu_torch.models.videollama import videollama_config_from

    out = {}
    vcfg = videollama_config_from(full_model_config(), 60)
    s = vl_prefix_len(vcfg, 60)
    holes = _vl_prompt_holes(vcfg, VL_BATCH)
    (row, cols), _ = holes[0]
    out["flash_videollama"] = check_flash(
        dev, VL_BATCH, vcfg.llm.num_heads, s, s + vcfg.max_new_tokens + 16, vcfg.llm.head_dim,
        gen, holes, (("interior_padding_ignored", (row, cols), 1),
                     ("kv_tile_skipped", (2, slice(512, 640)), 0)))
    out["flash_av21"] = av21_flash(dev, gen)
    gemvs = [check_gemv(dev, 1, kdim, n, False, gen) for kdim, n in av21_gemv_shapes()]
    out["gemv"] = gemvs
    out.update(av21_gemv_sums(gemvs, (2, 2, 2, 1)))
    return out


def av21_flash(dev, gen, m: int = 1) -> dict:
    """Flash at the 2.1-AV prefill (B = 1, S = 11123, the clip's prompt
    left-padded as a short query would leave it) on one of ``m`` model
    ranks: 28/m query heads over 4/m KV heads, K and V repeated after the
    head slice as ``models/llama.py`` feeds them; under the flash rule and
    its two controls."""
    from mraudio_tpu_torch.models.videollama import videollama21_av_config

    acfg = videollama21_av_config(60)
    s = vl_prefix_len(acfg, 60)
    (_, cols), _ = _vl_prompt_holes(acfg, 2)[0]
    return check_flash(
        dev, 1, acfg.llm.num_heads // m, s, s + acfg.max_new_tokens + 16, acfg.llm.head_dim, gen,
        (((0, cols), 0),), (("interior_padding_ignored", (0, cols), 1),
                            ("kv_tile_skipped", (0, slice(2944, 3072)), 0)),
        kv_from_heads=acfg.llm.num_kv_heads // m)


def av21_gemv_shapes(m: int = 1) -> list:
    """(K, N) of the 2.1-AV decode's distinct bf16 GEMVs on one of ``m``
    model ranks, the lm_head last.  One card (``m = 1``): q/o 3584², k/v
    3584 x 512, gate/up 3584 x 18944, down 18944 x 3584.  A rank's shards:
    q 3584 x 3584/m and k/v 3584 x 512/m (columns), o 3584/m x 3584 (rows),
    gate/up 3584 x 18944/m, down 18944/m x 3584; the lm_head 3584 x
    152064/m (at m = 4 the k/v shard is 128 columns: 2 strips of 128
    bytes)."""
    from mraudio_tpu_torch.models.videollama import videollama21_av_config

    llm = videollama21_av_config(60).llm
    h, kvd, f = llm.hidden_size, llm.num_kv_heads * llm.head_dim, llm.intermediate_size
    head = (h, llm.padded_vocab_size // m)
    if m == 1:
        return [(h, h), (h, kvd), (h, f), (f, h), head]
    return [(h, h // m), (h, kvd // m), (h // m, h), (h, f // m), (f // m, h), head]


def av21_gemv_sums(gemvs: list, counts: tuple) -> dict:
    """One Qwen2 layer's readings (each distinct shape taken ``counts``
    times, the lm_head last and apart) and the lm_head's."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    per_layer = [r for r, c in zip(gemvs, counts) for _ in range(c)]
    return dict(gemv_layer={k: sum(r[k] for r in per_layer) for k in keys},
                gemv_lm_head={k: gemvs[-1][k] for k in keys})


def _vl_generate(model, batch, **changes) -> dict:
    """One ``generate`` of a VideoLLaMA model with ``changes`` to its
    config, launch counts read around it: ``layers`` flash launches (one-
    shot prefill) and the GEMV's count for the passes made."""
    stats = {}
    set_launches(0)
    torch.cuda.reset_peak_memory_stats()
    with model_settings(model, **changes):
        torch.cuda.synchronize()
        t = time.perf_counter()
        tokens = model.generate_submit(batch=batch, stats=stats).cpu()
        texts = model.generate_finalize(tokens)
        wall = time.perf_counter() - t
    launches, passes = read_launches(), stats["decode_steps"]
    want = {"flash_attention": model.llm.cfg.num_layers,
            "decode_gemv": gemv_launches(model.llm.cfg, passes)}
    if launches != want:
        raise AssertionError(f"VideoLLaMA {changes}: launches {launches} for {passes} passes, "
                             f"want {want}")
    logits = stats["prefill_logits"][:, :model.llm.cfg.vocab_size].float()
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"VideoLLaMA {changes}: non-finite prefill logits")
    return dict(tokens=tokens, logits=logits, texts=texts, launches=launches, passes=passes,
                prefix_len=stats["prefix_len"], encode_s=stats["encode_s"],
                prefill_s=stats["prefill_s"], decode_s=stats["decode_s"], wall_s=wall,
                peak_mem_bytes=torch.cuda.max_memory_allocated())


def _default_route_logits(model, batch) -> tuple:
    """First-step logits of ``model`` under the default routes (chunked
    attention, XLA-route projections, 2048-token prefill segments), one
    decode step: no kernel may launch."""
    stats = {}
    set_launches(0)
    with llm_settings(model, attention_impl="chunked", decode_gemv="xla", prefill_chunk=2048), \
            model_settings(model, max_new_tokens=1):
        model.generate_submit(batch=batch, stats=stats)
    if read_launches() != {"flash_attention": 0, "decode_gemv": 0}:
        raise AssertionError(f"default routes launched kernels: {read_launches()}")
    return (stats["prefill_logits"][:, :model.llm.cfg.vocab_size].float(),
            stats["prefill_segments"], stats["prefill_s"])


def _vl_model(cfg, dev, seed: int):
    from mraudio_tpu_torch.config import AudioFrontendConfig, DATASET_MAX_AUDIO_SECONDS
    from mraudio_tpu_torch.models.casting import cast_params_for_inference
    from mraudio_tpu_torch.models.convert_jax import init_random_
    from mraudio_tpu_torch.models.videollama import VideoLLaMA

    audio_cfg = AudioFrontendConfig(max_audio_seconds=DATASET_MAX_AUDIO_SECONDS["QVH"])
    t = time.perf_counter()
    model = VideoLLaMA(cfg, audio_cfg=audio_cfg, device=dev)
    init_random_(model, seed=seed)
    cast_params_for_inference(model)
    lora = seed_lora_b_(model, seed)
    torch.cuda.synchronize()
    info = dict(init_s=time.perf_counter() - t, lora_targets_nonzero_b=lora,
                params=sum(p.numel() for p in model.parameters()),
                llm_params=sum(p.numel() for p in model.llm.parameters()),
                param_bytes=sum(p.numel() * p.element_size() for p in model.parameters()))
    return model, audio_cfg, info


def videollama_slice(dev, seed: int = 0) -> dict:
    """(c) The EVA-ViT-g + int8 Vicuna VideoLLaMA at full width and depth
    in the slice routes (flash, GEMV, one-shot prefill) on 4 synthetic QVH
    clips, two with left-padded prompts: 32 flash launches and 224 GEMV
    launches per pass; ``lookup_spec=4`` must give greedy's tokens; the
    first-step logits against the default routes are reported."""
    from mraudio_tpu_torch.config import DATASET_N_FRMS, full_model_config, slice_model_config
    from mraudio_tpu_torch.models.videollama import videollama_config_from
    from mraudio_tpu_torch.text.prompts import build_query_prompt

    n = DATASET_N_FRMS["QVH"]
    cfg = videollama_config_from(slice_model_config(full_model_config()), n)
    model, audio_cfg, info = _vl_model(cfg, dev, seed)
    batch = qvh_batch(VL_BATCH, n, cfg.vit.image_size, audio_cfg.max_audio_seconds,
                      audio_cfg.sampling_rate, seed=seed + 1)
    for r, q in VL_SHORT_QUERIES.items():
        batch.text_input[r] = build_query_prompt(q)
    greedy = _vl_generate(model, batch)
    lookup = _vl_generate(model, batch, lookup_spec=4)
    if not torch.equal(lookup["tokens"], greedy["tokens"]):
        raise AssertionError(f"VideoLLaMA lookup decoding differs from greedy: "
                             f"{lookup['texts']} vs {greedy['texts']}")
    default_logits, segments, default_prefill_s = _default_route_logits(model, batch)
    diff = (greedy["logits"] - default_logits).abs()
    del model
    summary = {k: v for k, v in greedy.items() if k not in ("tokens", "logits")}
    return dict(**info, layers=cfg.llm.num_layers, greedy=summary,
                clips_per_s=VL_BATCH / greedy["wall_s"],
                lookup={k: v for k, v in lookup.items() if k not in ("tokens", "logits", "texts")},
                lookup_tokens_equal_greedy=True, launches=greedy["launches"],
                lookup_launches=lookup["launches"],
                first_step_logits_vs_default=dict(
                    max_abs_diff=float(diff.max()),
                    rel_l2=float((greedy["logits"] - default_logits).norm()
                                 / default_logits.norm()),
                    argmax_equal=bool(torch.equal(greedy["logits"].argmax(-1),
                                                  default_logits.argmax(-1))),
                    default_prefill_segments=segments, default_prefill_s=default_prefill_s))


def videollama21_av(dev, seed: int = 0) -> dict:
    """(d) The published 2.1-AV architecture (SigLIP-so400m, Qwen2-7B with
    bf16 weights, BEATs) at full width and depth, seeded, in the slice
    routes on one synthetic QVH clip: 28 flash launches and 197 GEMV
    launches per pass (7 per layer and the lm_head, which tiles), plus the
    prefill's lm_head; its first-step logits held against the default
    routes (:data:`AV21_LOGITS_REL_L2`).  SigLIP's stride-14 patch
    convolution reads the top-left 378² of a 384² frame, so the clip's
    frames are 378²: the same 27 x 27 patches."""
    from mraudio_tpu_torch.config import DATASET_N_FRMS
    from mraudio_tpu_torch.models.videollama import videollama21_av_config

    n = DATASET_N_FRMS["QVH"]
    cfg = videollama21_av_config(n)
    cfg = cfg.replace(llm=cfg.llm.replace(attention_impl="pallas", decode_gemv="pallas",
                                          prefill_chunk=0))
    model, audio_cfg, info = _vl_model(cfg, dev, seed)
    grid = cfg.vit.image_size // cfg.vit.patch_size * cfg.vit.patch_size
    batch = qvh_batch(1, n, grid, audio_cfg.max_audio_seconds, audio_cfg.sampling_rate,
                      seed=seed + 1)
    run = _vl_generate(model, batch)
    default_logits, segments, default_prefill_s = _default_route_logits(model, batch)
    rel = float((run["logits"] - default_logits).norm() / default_logits.norm())
    del model
    result = dict(**info, layers=cfg.llm.num_layers, frame=grid,
                  greedy={k: v for k, v in run.items() if k not in ("tokens", "logits")},
                  launches=run["launches"], gemv_launches_per_pass=gemv_launches(cfg.llm, 1) - 1,
                  first_step_logits_vs_default=dict(
                      rel_l2=rel, limit=AV21_LOGITS_REL_L2,
                      max_abs_diff=float((run["logits"] - default_logits).abs().max()),
                      logits_rms=float(default_logits.square().mean().sqrt()),
                      argmax_equal=bool(torch.equal(run["logits"].argmax(-1),
                                                    default_logits.argmax(-1))),
                      default_prefill_segments=segments, default_prefill_s=default_prefill_s))
    if not rel <= AV21_LOGITS_REL_L2:
        raise AssertionError(f"2.1-AV: slice vs default first-step logits rel L2 {rel} > "
                             f"{AV21_LOGITS_REL_L2}")
    return result


# --------------------------------------------------------------------------
# Phase 19: the quantized formats and the single-chip memory levers
# --------------------------------------------------------------------------

# first-step logits over the int4 cache against the int8 cache's, same
# weights and inputs: int4 keeps 15 levels per head row (step absmax / 7)
# where int8 keeps 255, so K and V carry about 10% rms error, which 32
# layers of random weights carry into the logits at a comparable size; the
# JAX package's own test holds the int4 cache to argmax agreement on half
# the rows (tests/test_kv_int4.py:145)
INT4_KV_LOGIT_REL_L2 = 0.5
QUANT_TOKENS = 16       # greedy budget of the quant_slice and quant_w8a8 runs


def _counted_generate(model, batch, max_new: int):
    """One ``generate`` with ``max_new`` tokens, the launch counts read
    around it: ``(tokens, stats, launches, seconds)``."""
    stats = {}
    set_launches(0)
    with model_settings(model, max_new_tokens=max_new):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pending = model.generate_submit(batch=batch, stats=stats)
        tokens = pending[0].cpu()
        wall = time.perf_counter() - t
    return tokens, stats, read_launches(), wall


def decode_attention_int4_vs_int8(dev, b, h, s, d, gen) -> dict:
    """One layer's greedy decode attention (``chunked_attention``'s one-pass
    tile, one batch row at a time) over the int4 cache and the int8 cache
    of the same keys and values, at the slice's cache length, timed with
    CUDA events; each beside its byte bound."""
    from mraudio_tpu_torch.infer.generate import MAX_SPEC_WIDTH
    from mraudio_tpu_torch.models.llama import quantize_kv, quantize_kv4
    from mraudio_tpu_torch.ops.attention import chunked_attention

    kv = s + 64 + MAX_SPEC_WIDTH
    k = torch.randn((b, kv, h, d), generator=gen, device=dev)
    v = torch.randn((b, kv, h, d), generator=gen, device=dev)
    q = torch.randn((b, 1, h, d), generator=gen, device=dev).to(torch.bfloat16)
    mask = torch.ones((b, kv), dtype=torch.int32, device=dev)
    col = s + 10
    out = {}
    for name, quantize, per_value in (("int8", quantize_kv, 1.0), ("int4", quantize_kv4, 0.5)):
        kq, ks = quantize(k)
        vq, vs = quantize(v)
        ks, vs = ks.transpose(1, 2).contiguous(), vs.transpose(1, 2).contiguous()
        kw = dict(causal=True, k_scale=ks, v_scale=vs, scales_bhs=True, kv_bshd=True,
                  q_bshd=True, q_offset=col, kv_packed=name == "int4")
        got = chunked_attention(q, kq, vq, mask, **kw)
        if not bool(torch.isfinite(got.float()).all()):
            raise AssertionError(f"decode attention over the {name} cache: non-finite output")
        ms = cuda_ms(lambda: chunked_attention(q, kq, vq, mask, **kw), iters=20)
        nbytes = 2 * per_value * b * kv * h * d + 2 * 4.0 * b * h * kv + 4.0 * b * kv
        flops = 4.0 * h * d * b * (col + 1)
        bms, by = bound_ms(nbytes, flops, PEAK_BF16_TENSOR_FLOPS)
        out[name] = dict(ms=ms, bound_ms=bms, bound_by=by)
        del kq, vq
    return dict(shape=dict(b=b, h=h, kv=kv, d=d), per="one layer, one greedy step", **out)


def quant_slice(dev, seed: int = 0) -> dict:
    """The slice model at full width and depth with the int4 cache and the
    ``scan_layers`` layout, on the 3-clip QVH batch (greedy,
    ``QUANT_TOKENS`` tokens): 32 flash and 224 GEMV launches per pass
    (int8 weights); the same weights through the store's stacked names
    into a per-layer model give the same tokens, bit for bit; the int8
    cache's first-step logits against the int4 cache's within
    ``INT4_KV_LOGIT_REL_L2``; the decode attention per layer over both
    caches."""
    from mraudio_tpu_torch.config import (DATASET_MAX_AUDIO_SECONDS, DATASET_N_FRMS,
                                          AudioFrontendConfig, full_model_config,
                                          slice_model_config)
    from mraudio_tpu_torch.models.convert_jax import flax_params, load_jax_params_, nested
    from mraudio_tpu_torch.models.llama import LlamaModel

    base = slice_model_config(full_model_config())
    cfg = base.replace(llm=base.llm.replace(kv_quant="int4", scan_layers=True))
    audio_cfg = AudioFrontendConfig(max_audio_seconds=DATASET_MAX_AUDIO_SECONDS["QVH"])
    model = build_model(cfg, audio_cfg, dev, seed)
    seed_lora_b_(model, seed)
    batch = qvh_batch(3, DATASET_N_FRMS["QVH"], cfg.vit.image_size,
                      DATASET_MAX_AUDIO_SECONDS["QVH"], audio_cfg.sampling_rate, seed=seed + 1)
    layers, v = cfg.llm.num_layers, cfg.llm.vocab_size
    torch.cuda.reset_peak_memory_stats()
    scan_tokens, stats, launches, wall = _counted_generate(model, batch, QUANT_TOKENS)
    passes = stats["decode_steps"]
    want = {"flash_attention": layers, "decode_gemv": gemv_launches(cfg.llm, passes)}
    if launches != want:
        raise AssertionError(f"quant_slice: launches {launches} for {passes} passes, want {want}")
    peak = torch.cuda.max_memory_allocated()
    scan_logits = stats["prefill_logits"].float().cpu()
    if not bool(torch.isfinite(scan_logits[:, :v]).all()):
        raise AssertionError("quant_slice: non-finite prefill logits")

    # the decoder in the per-layer layout from the stacked names the store
    # and the checkpoints carry, in place of the scan-layout decoder
    t = time.perf_counter()
    stacked = {k: v for k, v in flax_params(model).items() if k.startswith("llm/")}
    if not any(k.startswith("llm/layers/") for k in stacked) or any(
            k.startswith("llm/layer_") for k in stacked):
        raise AssertionError("quant_slice: flax_params did not stack the decoder layers")
    with torch.device(dev):
        loop_llm = LlamaModel(cfg.llm.replace(scan_layers=False), cfg.lora)
    load_jax_params_(loop_llm, nested(stacked)["llm"])
    model.llm = loop_llm
    del stacked
    gc.collect()
    torch.cuda.empty_cache()
    layout_s = time.perf_counter() - t
    loop_tokens, loop_stats, loop_launches, _ = _counted_generate(model, batch, QUANT_TOKENS)
    if not torch.equal(loop_tokens, scan_tokens) or loop_launches != launches:
        raise AssertionError(f"quant_slice: the per-layer layout gives other tokens or launches "
                             f"({loop_launches})")

    with llm_settings(model, kv_quant="int8"):
        int8_tokens, int8_stats, _, _ = _counted_generate(model, batch, 1)
    int8_logits = int8_stats["prefill_logits"].float().cpu()
    rel = float((scan_logits[:, :v] - int8_logits[:, :v]).norm() / int8_logits[:, :v].norm())
    argmax_agree = float((scan_logits[:, :v].argmax(-1) == int8_logits[:, :v].argmax(-1))
                         .float().mean())
    result = dict(layers=layers, kv_quant="int4", scan_layers=True, prefix_len=stats["prefix_len"],
                  decode_steps=passes, launches=launches,
                  launches_per_pass=dict(flash_attention=launches["flash_attention"],
                                         decode_gemv=launches["decode_gemv"] / passes),
                  encode_s=stats["encode_s"], prefill_s=stats["prefill_s"],
                  decode_s=stats["decode_s"], wall_s=wall, clips_per_s=3 / wall,
                  peak_mem_bytes=peak, layout_round_trip_s=layout_s,
                  loop_layout_tokens_identical=True,
                  first_step_logits_vs_int8_cache=dict(rel_l2=rel, limit=INT4_KV_LOGIT_REL_L2,
                                                       argmax_agreement=argmax_agree),
                  texts=model.generate_finalize((scan_tokens, None)))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    result["decode_attention"] = decode_attention_int4_vs_int8(
        dev, 3, 32, stats["prefix_len"], 128, gen)
    emit({"phase": "quant_slice_readings", **result})
    if not rel <= INT4_KV_LOGIT_REL_L2:
        raise AssertionError(f"quant_slice: first-step logits over the int4 cache at rel L2 {rel} "
                             f"of the int8 cache's (limit {INT4_KV_LOGIT_REL_L2})")
    return result


def quant_evaluate() -> dict:
    """The evaluate CLI at full width and depth with the bench knobs
    (``quantization: int4``, ``kv_quant: int4``) in a JSON ``--config``,
    ``--quant-encoders``, the deployed default routes and grammar decoding
    (``spec_width`` 4, so that every prediction must parse), on 3 synthetic
    QVH clips at batch 3: 0 launches, 0 invalid predictions; the model's
    weight bytes by part and the peak memory."""
    import mraudio_tpu_torch.infer.evaluate as infer_evaluate
    from mraudio_tpu_torch.cli import evaluate as cli
    from mraudio_tpu_torch.config import DataConfig, RunConfig, full_model_config
    from mraudio_tpu_torch.eval.mr_eval import eval_submission

    root = Path(__file__).resolve().parent / "build" / "smoke_quant_evaluate"
    root.mkdir(parents=True, exist_ok=True)
    anns = [{"vid": f"v{i}", "qid": i, "query": QUERIES[i % 3], "duration": 150,
             "relevant_windows": [[10.0 + 24 * i, 34.0 + 24 * i]]} for i in range(3)]
    gt, out, config = root / "annotations.jsonl", root / "predictions.jsonl", root / "run.json"
    gt.write_text("".join(json.dumps(a) + "\n" for a in anns))
    full = full_model_config()
    config.write_text(json.dumps(RunConfig(
        model=full.replace(llm=full.llm.replace(quantization="int4", kv_quant="int4"),
                           constrained_decoding=True, spec_width=4),
        data=DataConfig.for_dataset("QVH")).to_dict()))
    seen = {}
    real = infer_evaluate.run_inference

    def capture(cfg, model=None, **kw):
        result = real(cfg, model=model, **kw)
        enc = set(model.ENCODER_PARAM_KEYS)
        parts = {}
        for name, p in model.named_parameters():
            part = "llm" if name.startswith("llm.") else ("encoders" if name.split(".")[0] in enc
                                                          else "other")
            parts[part] = parts.get(part, 0) + p.numel() * p.element_size()
        seen.update(weight_bytes=parts, int8_kernels=sum(
            n.endswith("kernel.original0") for n, _ in model.named_parameters()))
        return result

    infer_evaluate.run_inference = capture
    torch.cuda.reset_peak_memory_stats()
    set_launches(0)
    t = time.perf_counter()
    try:
        result = cli.main(["--annotation-file", str(gt), "--output-file", str(out),
                           "--config", str(config), "--video-source", "synthetic",
                           "--batch-size", "3", "--quant-encoders"])
    finally:
        infer_evaluate.run_inference = real
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = read_launches()
    records = result["records"]
    metrics = eval_submission(records, anns, verbose=False)
    readings = dict(records=len(records), launches=launches,
                    clips_per_sec=result["clips_per_sec"], wall_s_with_model_build=wall,
                    batches=result["batches"], peak_mem_bytes=torch.cuda.max_memory_allocated(),
                    brief=dict(metrics["brief"]), raw_out=[r["raw_out"] for r in records], **seen)
    emit({"phase": "quant_evaluate_readings", **readings})
    if launches != {"flash_attention": 0, "decode_gemv": 0}:
        raise AssertionError(f"quant_evaluate launched kernels: {launches}")
    if [r["qid"] for r in records] != list(range(3)) or \
            metrics["brief"]["MR-full-invalid_pred_num"] != 0:
        raise AssertionError(f"quant_evaluate: {len(records)} records, {metrics['brief']}")
    if not seen.get("int8_kernels"):
        raise AssertionError("quant_evaluate: no encoder kernel was stored int8")
    return readings


def projection_layer_ms(dev, b, gen, llm_cfg, cold_bytes=160e6) -> dict:
    """One decoder layer's seven projections (q, k, v, o, gate, up, down)
    through ``LlamaLinear`` under ``llm_cfg`` (int8 weights, or int4 with
    ``quantization="int4"``) at ``b`` rows, device time by CUDA-graph
    replay with the weights rotated past the L2."""
    from mraudio_tpu_torch.models.convert_jax import init_random_
    from mraudio_tpu_torch.models.llama import LlamaLinear

    per_shape = {}
    for kdim, n in ((4096, 4096), (4096, 11008), (11008, 4096)):
        copies = max(1, int(np.ceil(cold_bytes / (kdim * n))))
        x, ws, scale = _gemv_inputs(b, kdim, n, True, gen, copies)
        with torch.device(dev):
            lins = [LlamaLinear(kdim, n, llm_cfg) for _ in range(copies)]
        for i, (lin, w) in enumerate(zip(lins, ws)):
            if lin.int4:
                init_random_(lin, seed=i)
            else:
                lin.w_int8.data, lin.scale.data = w, scale
        it = [0]

        def call(lins=lins, x=x, it=it):
            it[0] = (it[0] + 1) % len(lins)
            return lins[it[0]](x)

        per_shape[f"{kdim}x{n}"] = graph_ms(call)
    return dict(ms_by_shape=per_shape, layer_ms=4 * per_shape["4096x4096"]
                + 2 * per_shape["4096x11008"] + per_shape["11008x4096"])


def quant_w8a8(dev, seed: int = 0) -> dict:
    """The model at full width, the decoder cut to :data:`CUT_LAYERS`, with
    ``int8_dot`` (W8A8) in the default routes on the 3-clip QVH batch
    (``QUANT_TOKENS`` tokens): 0
    launches (W8A8 precedes the GEMV route), finite logits; from the
    batch's own prefix, each row's greedy tokens alone equal its tokens in
    the 3-row batch, bit for bit; one layer's projections at 3 rows
    through W8A8, the XLA route and the GEMV kernel."""
    from mraudio_tpu_torch.config import (DATASET_MAX_AUDIO_SECONDS, DATASET_N_FRMS,
                                          AudioFrontendConfig, full_model_config)
    from mraudio_tpu_torch.infer.generate import greedy_generate

    full = full_model_config()
    cfg = full.replace(llm=full.llm.replace(int8_dot=True, num_layers=CUT_LAYERS))
    audio_cfg = AudioFrontendConfig(max_audio_seconds=DATASET_MAX_AUDIO_SECONDS["QVH"])
    model = build_model(cfg, audio_cfg, dev, seed)
    seed_lora_b_(model, seed)
    batch = qvh_batch(3, DATASET_N_FRMS["QVH"], cfg.vit.image_size,
                      DATASET_MAX_AUDIO_SECONDS["QVH"], audio_cfg.sampling_rate, seed=seed + 1)
    torch.cuda.reset_peak_memory_stats()
    tokens, stats, launches, wall = _counted_generate(model, batch, QUANT_TOKENS)
    peak = torch.cuda.max_memory_allocated()
    if launches != {"flash_attention": 0, "decode_gemv": 0}:
        raise AssertionError(f"quant_w8a8 launched kernels: {launches}")
    if not bool(torch.isfinite(stats["prefill_logits"][:, :cfg.llm.vocab_size]).all()):
        raise AssertionError("quant_w8a8: non-finite prefill logits")
    eos = model.llm_tokenizer.eos_token_id
    with torch.inference_mode():
        text = model.prepare_text(batch.text_input, batch.timestamps, batch.duration)
        embeds, mask = model.prefix_embeds(*model.device_inputs(batch), text,
                                           batch.timestamps.shape[1])
        t = time.perf_counter()
        rows = greedy_generate(model.llm, embeds, mask, QUANT_TOKENS, eos).cpu()
        alone = [greedy_generate(model.llm, embeds[i:i + 1], mask[i:i + 1], QUANT_TOKENS,
                                 eos).cpu() for i in range(3)]
        rows_s = time.perf_counter() - t
    if not all(torch.equal(alone[i][0], rows[i]) for i in range(3)):
        raise AssertionError("quant_w8a8: a row alone gives other tokens than in the batch")
    del model, embeds
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    routes = {name: projection_layer_ms(dev, 3, gen, full.llm.replace(**kw))
              for name, kw in (("w8a8", dict(int8_dot=True)), ("xla", {}),
                               ("gemv", dict(decode_gemv="pallas")),
                               ("int4", dict(quantization="int4")))}
    # torch._int_mm alone at the down projection's shape (32 padded rows),
    # the weight row-major as the model stores it and column-major
    x8 = torch.randint(-127, 128, (32, 11008), generator=gen, device=dev, dtype=torch.int8)
    w8 = torch.randint(-127, 128, (11008, 4096), generator=gen, device=dev, dtype=torch.int8)
    w8_col = w8.t().contiguous().t()
    if not torch.equal(torch._int_mm(x8, w8), torch._int_mm(x8, w8_col)):
        raise AssertionError("quant_w8a8: torch._int_mm differs between weight layouts")
    int_mm_ms = dict(row_major=graph_ms(lambda: torch._int_mm(x8, w8)),
                     column_major=graph_ms(lambda: torch._int_mm(x8, w8_col)))
    result = dict(decode_steps=stats["decode_steps"], encode_s=stats["encode_s"],
                  prefill_s=stats["prefill_s"], decode_s=stats["decode_s"], wall_s=wall,
                  clips_per_s=3 / wall, peak_mem_bytes=peak, launches=launches,
                  rows_alone_bit_identical=True, rows_s=rows_s,
                  int_mm_11008x4096_m32_l2_warm_ms=int_mm_ms,
                  projection_layer_ms_b3={k: r["layer_ms"] for k, r in routes.items()},
                  projection_ms_by_shape={k: r["ms_by_shape"] for k, r in routes.items()})
    emit({"phase": "quant_w8a8_readings", **result})
    return result


def quant_serve(dev) -> dict:
    """The engine over the int4 cache under SnapKV ``kv_keep`` (1784, the
    serve profile's), in the 8-layer serving model: 4 slots, admissions of
    2, 2 steps per dispatch; each request's tokens equal the offline
    greedy decoder's at batch 3 under the same settings; 0 launches."""
    from mraudio_tpu_torch.infer.generate import greedy_generate
    from mraudio_tpu_torch.infer.serving import ContinuousBatcher

    model, requests = serve_model(dev)
    llm, eos = model.llm, model.llm_tokenizer.eos_token_id
    max_new = model.cfg.max_new_tokens
    reqs = [r for r, _ in requests]
    s = reqs[0].prefix_embeds.shape[0]
    set_launches(0)
    with llm_settings(model, kv_quant="int4", kv_keep=1784):
        t = time.perf_counter()
        offline = greedy_generate(
            llm, torch.stack([r.prefix_embeds for r in reqs[:3]]),
            torch.from_numpy(np.stack([r.prefix_mask for r in reqs[:3]])).to(model.device),
            max_new, eos).cpu().numpy()
        offline_s = time.perf_counter() - t
        engine = ContinuousBatcher(llm, s, max_new, eos, max_slots=4, max_prefill_batch=2,
                                   steps_per_dispatch=2)
        if engine.cache[0]["k"].dtype != torch.uint8:
            raise AssertionError("quant_serve: the engine's cache is not int4")
        tokens, dispatches, secs = drive_engine(engine, reqs[:3])
        engine.close()
    same_tokens(tokens, offline, eos, "engine over the int4 cache with kv_keep vs offline")
    if read_launches() != {"flash_attention": 0, "decode_gemv": 0}:
        raise AssertionError(f"quant_serve launched kernels: {read_launches()}")
    result = dict(layers=llm.cfg.num_layers, prefix_len=s, kv_keep=1784, kv_quant="int4",
                  tokens_identical=True, offline_greedy_s=offline_s,
                  engine_dispatches=dispatches, engine_s=secs)
    emit({"phase": "quant_serve_readings", **result})
    return result


_SINGLE_CHIP_RUNNER = r"""
import json, sys, time
import torch
import chip_smoke
from mraudio_tpu_torch.cli import finetune
from mraudio_tpu_torch.train import trainer as trainer_mod

out = {"step_s": [], "window_s": [], "upload_s": [], "step_peak_bytes": [], "seq_len": None}
T = trainer_mod.Trainer
real_loss_step, real_upload, real_inputs = T._loss_step, T._encoders_to_device, T._step_inputs

def timed(fn, key):
    def wrap(self, *a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn(self, *a, **kw)
        torch.cuda.synchronize()
        out[key].append(time.perf_counter() - t)
        return r
    return wrap

def loss_step(self, modal, arrays, key):
    torch.cuda.reset_peak_memory_stats()
    loss = timed(real_loss_step, "step_s")(self, modal, arrays, key)
    out["step_peak_bytes"].append(torch.cuda.max_memory_allocated())
    out.setdefault("encoders_on_device_in_steps", False)
    out["encoders_on_device_in_steps"] |= self.encoders_on_device()
    return loss

def step_inputs(self, batch, step):
    if out["seq_len"] is None:
        m, n = self.model, batch.timestamps.shape[1]
        text = m.prepare_text(batch.text_input, batch.timestamps, batch.duration,
                              text_output=batch.text_output)
        out["seq_len"] = int(m.prefix_mask_host(text, n).shape[1] - text.prompt_mask.shape[1]
                             + text.concat_ids.shape[1])
        out["n_frms"] = int(n)
        out["encoder_bytes"] = self._enc_nbytes
    return real_inputs(self, batch, step)

T._loss_step = loss_step
T._encoders_to_device = timed(real_upload, "upload_s")
T._step_inputs = step_inputs
T._train_epoch_windowed = timed(T._train_epoch_windowed, "window_s")
chip_smoke.set_launches(0)
t = time.perf_counter()
summary = finetune.main(sys.argv[1:])
torch.cuda.synchronize()
out["wall_s"] = time.perf_counter() - t
out["launches"] = chip_smoke.read_launches()
out["summary"] = {k: v for k, v in summary.items() if k != "results"}
print("SINGLE_CHIP " + json.dumps(out), flush=True)
"""


def single_chip_cli() -> dict:
    """The finetune CLI with ``--single-chip`` in a process of its own at
    full width and depth (remat, ``scan_layers``, int8 frozen encoders,
    the split encode step, ``encoder_window`` 12): 8 synthetic QVH clips
    at batch 2 (4 micro-steps in one window), validation on 1 clip.  Every
    loss finite, the checkpoint's LoRA leaves stacked and moved, no encoder
    leaf on the device during a loss step, 0 launches; seconds per micro-
    step (the window's wall over its steps, and each loss step alone),
    MFU, the loss steps' peak memory."""
    from mraudio_tpu_torch.config import (DATASET_MAX_AUDIO_SECONDS, AudioFrontendConfig,
                                          full_model_config)
    from mraudio_tpu_torch.train.checkpoint import load_checkpoint
    from mraudio_tpu_torch.utils.flops import peak_flops_for, train_step_flops

    root = Path(__file__).resolve().parent / "build" / "smoke_single_chip"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    train_ann, val_ann, out = root / "train.jsonl", root / "val.jsonl", root / "out"
    train_ann.write_text("".join(json.dumps(a) + "\n" for a in train_annotations(TRAIN_CLIPS)))
    val_ann.write_text("".join(json.dumps(a) + "\n" for a in train_annotations(1, TRAIN_CLIPS)))
    args = ["--model-size", "full", "--single-chip", "--video-source", "synthetic",
            "--batch-size", str(TRAIN_BATCH), "--max-epoch", "1", "--save-freq", "1",
            "--train-annotation-file", str(train_ann), "--val-annotation-file", str(val_ann),
            "--output-dir", str(out)]
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _SINGLE_CHIP_RUNNER, *args],
                          cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                          timeout=900)
    wall = time.perf_counter() - t
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("SINGLE_CHIP ")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"finetune --single-chip failed ({proc.returncode}): "
                             f"{proc.stderr[-3000:]}")
    run = json.loads(lines[-1][len("SINGLE_CHIP "):])
    events = [json.loads(ln) for ln in (out / "train.jsonl").read_text().splitlines()]
    losses = [e["loss"] for e in events if e["event"] == "train_step"]
    windows = [e for e in events if e["event"] == "window"]
    steps = TRAIN_CLIPS // TRAIN_BATCH
    e2e_s = run["window_s"][0] / steps
    audio_cfg = AudioFrontendConfig(max_audio_seconds=DATASET_MAX_AUDIO_SECONDS["QVH"])
    flops = train_step_flops(full_model_config(), audio_cfg, run["n_frms"], TRAIN_BATCH,
                             run["seq_len"], grad_checkpoint=True)
    peak = peak_flops_for(torch.cuda.get_device_name(0))
    trained = load_checkpoint(str(out / "checkpoint_0"))["model"]
    lora_b = {k: v for k, v in trained.items() if k.endswith("lora_b")}
    result = dict(subprocess_wall_s=wall, cli_wall_s=run["wall_s"], losses=losses,
                  windows=windows, window_s=run["window_s"], upload_s=run["upload_s"],
                  loss_step_s=run["step_s"], s_per_micro_step_e2e=e2e_s,
                  s_per_loss_step_median_2_4=float(np.median(run["step_s"][1:4])),
                  train_clips_per_s=TRAIN_BATCH / e2e_s, train_step_flops=flops,
                  train_mfu=flops["total"] / (e2e_s * peak), seq_len=run["seq_len"],
                  encoder_packed_bytes=run["encoder_bytes"],
                  loss_step_peak_mem_bytes=max(run["step_peak_bytes"]),
                  encoders_on_device_in_loss_steps=run["encoders_on_device_in_steps"],
                  launches=run["launches"], summary=run["summary"],
                  stacked_lora_leaves=sorted(k for k in lora_b)[:2],
                  lora_b_moved=sum(bool(v.abs().amax() > 0) for v in lora_b.values()))
    emit({"phase": "single_chip_readings", **result})
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"single_chip: losses {losses}")
    if [w["batches"] for w in windows] != [steps] or any(
            w["encoders_on_device_during_steps"] for w in windows) or \
            run["encoders_on_device_in_steps"]:
        raise AssertionError(f"single_chip: windows {windows}")
    if run["launches"] != {"flash_attention": 0, "decode_gemv": 0}:
        raise AssertionError(f"single_chip launched kernels: {run['launches']}")
    layers = full_model_config().llm.num_layers
    if len(lora_b) != 7 or any(v.shape[0] != layers or not bool((v.abs().amax(dim=(1, 2)) > 0)
                                                                  .all()) for v in lora_b.values()):
        raise AssertionError(f"single_chip: stacked LoRA B leaves {sorted(lora_b)}")
    shutil.rmtree(root, ignore_errors=True)
    return result


def window_identities(dev) -> dict:
    """On the narrow model of the training identities (2 decoder layers, 2
    ViT blocks, 8 frames): one epoch of 4 micro-steps at batch 1 with
    ``encoder_window=2`` and ``upload_overlap`` gives the per-batch split
    run's losses and trained leaves, bit for bit, with the second window's
    upload staged during the first window's loss steps."""
    from mraudio_tpu_torch.infer.evaluate import build_model as build_trained
    from mraudio_tpu_torch.train import trainer as trainer_mod

    root = Path(__file__).resolve().parent / "build" / "smoke_window_id"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    train_ann, val_ann = root / "train.jsonl", root / "val.jsonl"
    train_ann.write_text("".join(json.dumps(a) + "\n" for a in train_annotations(4)))
    val_ann.write_text("".join(json.dumps(a) + "\n" for a in train_annotations(1, 4)))
    runs = {}
    model = initial = None
    for name, train in (("split", {}), ("window", dict(encoder_window=2, upload_overlap=True))):
        cfg = identities_config(batch_size=1, max_epoch=1, num_workers=1,
                                output_dir=str(root / name), **train)
        cfg = cfg.replace(data=cfg.data.replace(train_annotation_file=str(train_ann),
                                                val_annotation_file=str(val_ann)))
        if model is None:
            model = build_trained(cfg, dev)
            initial = {n: p.detach().clone() for n, p in model.named_parameters()
                       if "lora" in n}
        with torch.no_grad():
            params = dict(model.named_parameters())
            for n, p in initial.items():
                params[n].data = p.clone()
        trainer = trainer_mod.Trainer(cfg, model=model, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainer.train_epoch(0)
        torch.cuda.synchronize()
        events = [json.loads(ln) for ln in (root / name / "train.jsonl").read_text().splitlines()]
        runs[name] = dict(losses=[e["loss"] for e in events if e["event"] == "train_step"],
                          windows=[e for e in events if e["event"] == "window"],
                          leaves={k: p.detach().clone() for k, p in trainer.trainable.items()},
                          seconds=time.perf_counter() - t)
        trainer._restore_sigterm()
    split, window = runs["split"], runs["window"]
    staged = [w["staged_upload"] for w in window["windows"]]
    result = dict(losses=window["losses"], windows=window["windows"],
                  staged_path_ran=any(staged),
                  run_seconds=dict(split=split["seconds"], window=window["seconds"]))
    emit({"phase": "window_identities_readings", **result})
    if window["losses"] != split["losses"] or len(split["losses"]) != 4:
        raise AssertionError(f"window identities: losses {window['losses']} vs {split['losses']}")
    if sorted(window["leaves"]) != sorted(split["leaves"]) or not all(
            torch.equal(window["leaves"][k], split["leaves"][k]) for k in split["leaves"]):
        raise AssertionError("window identities: trained leaves differ from the split run's")
    if [w["batches"] for w in window["windows"]] != [2, 2] or any(
            w["encoders_on_device_during_steps"] for w in window["windows"]):
        raise AssertionError(f"window identities: windows {window['windows']}")
    shutil.rmtree(root, ignore_errors=True)
    return dict(result, bit_identical=True)


# --------------------------------------------------------------------------
# Phase 20: parallelism — the mesh over NCCL, one process per card
# --------------------------------------------------------------------------

# the evaluate CLI on a mesh: the serving depth at full width, 2 clips
PARALLEL_LAYERS = SERVE_LAYERS
PARALLEL_CLIPS = 2
# model = 4 against one card at full width and depth (bf16): the first-step
# logits within this relative L2 (sums in another order, as a route
# change: 0.01-0.05 between the slice and default routes, PR 8)
TP_LOGIT_REL_L2 = 0.10
# data = 2 x model = 2 finetune against one card at the same global batch
TP_TRAIN_LOSS_RTOL = TRAIN_LOSS_RTOL

_PARALLEL_RUNNER = r"""
import hashlib, json, os, sys, time
from pathlib import Path
import torch
import chip_smoke

mode, out = sys.argv[1], Path(sys.argv[2])
rank, world = int(os.environ.get("RANK", 0)), int(os.environ.get("WORLD_SIZE", 1))
cuda = "--device" not in sys.argv
tag = f"{mode}_{world}_{rank}"

def peak():
    return torch.cuda.max_memory_allocated() if cuda else 0

def save(obj):
    (out / f"{tag}.json").write_text(json.dumps(obj))

# the trainable leaves outside the decoder (VideoLLaMA's connector and audio
# projector): whether the run moved each, and a digest of its bytes
replicated = {}
if mode == "finetune":
    from mraudio_tpu_torch.train import trainer as trainer_mod
    real_train = trainer_mod.Trainer.train

    def recorded(self):
        start = {k: p.detach().clone() for k, p in self.trainable.items()
                 if not k.startswith("llm/")}
        summary = real_train(self)
        for k, p in start.items():
            now = self.trainable[k].detach()
            replicated[k] = dict(moved=not torch.equal(now, p), sha256=hashlib.sha256(
                now.float().cpu().numpy().tobytes()).hexdigest())
        return summary

    trainer_mod.Trainer.train = recorded

chip_smoke.set_launches(0)
t = time.perf_counter()
if mode in ("evaluate", "finetune"):
    from mraudio_tpu_torch.cli import evaluate, finetune
    (evaluate if mode == "evaluate" else finetune).main(sys.argv[3:])
    if cuda:
        torch.cuda.synchronize()
    save(dict(rank=rank, world=world, launches=chip_smoke.read_launches(),
              peak_mem_bytes=peak(), wall_s=time.perf_counter() - t, replicated=replicated))
elif mode == "generate_av21":   # the 2.1-AV decoder over a 1 x world mesh
    save(chip_smoke.tp_generate_av21(out, rank, world, cuda))
else:   # generate [--device cpu]: the slice model over a 1 x world mesh
    save(chip_smoke.tp_generate(out, rank, world, cuda))
"""


def tp_generate(out: Path, rank: int, world: int, cuda: bool) -> dict:
    """In one process of a ``world``-card launch (or alone): the slice
    model at full width and depth, seeded, with its LoRA B non-zero,
    sliced over a 1 x ``world`` mesh; greedy on 3 synthetic QVH clips,
    then with ``seq_shard``, then grammar decoding at ``spec_width`` 4 and
    1.  Rank 0 saves the tokens and the first-step logits; every rank
    returns its launches, seconds and peak memory.  Without a card: the
    tiny f32 model on gloo (the rehearsal on the CPU)."""
    from mraudio_tpu_torch import parallel
    from mraudio_tpu_torch.config import (DATASET_MAX_AUDIO_SECONDS, DATASET_N_FRMS,
                                          AudioFrontendConfig, MeshConfig, full_model_config,
                                          slice_model_config, tiny_data_config,
                                          tiny_model_config)
    from mraudio_tpu_torch.device import init_distributed

    dev = init_distributed("cuda" if cuda else "cpu") if world > 1 else torch.device(
        "cuda" if cuda else "cpu")
    if cuda:
        cfg = slice_model_config(full_model_config())
        audio_cfg = AudioFrontendConfig(max_audio_seconds=DATASET_MAX_AUDIO_SECONDS["QVH"])
        n_frms = DATASET_N_FRMS["QVH"]
    else:
        tiny = tiny_model_config()
        cfg = slice_model_config(tiny.replace(llm=tiny.llm.replace(dtype="float32")))
        audio_cfg, n_frms = tiny_data_config().audio, 4
    a = audio_cfg
    seconds = (a.max_audio_seconds if cuda else
               (a.hop_length * (n_frms * a.mel_frames_per_chunk - 1) + a.win_length)
               / a.sampling_rate)
    t = time.perf_counter()
    model = build_model(cfg, audio_cfg, dev, 0)
    seed_lora_b_(model, 0)
    if world > 1:
        parallel.shard_module_(model, parallel.make_mesh(MeshConfig(data=1, model=world)))
    if cuda:
        torch.cuda.synchronize()
    res = dict(rank=rank, world=world, init_s=time.perf_counter() - t)
    batch = qvh_batch(3, n_frms, cfg.vit.image_size, seconds, a.sampling_rate, seed=1)
    saved = {}
    for name, llm, asm in (("greedy", {}, {}), ("seq_shard", dict(seq_shard=True), {}),
                           ("grammar4", {}, dict(constrained_decoding=True, spec_width=4)),
                           ("grammar1", {}, dict(constrained_decoding=True, spec_width=1))):
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        stats = {}
        set_launches(0)
        with llm_settings(model, **llm), model_settings(model, **asm):
            t = time.perf_counter()
            tokens, _ = model.generate_submit(batch=batch, stats=stats)
            tokens = tokens.cpu()
            wall = time.perf_counter() - t
        res[name] = dict(launches=read_launches(), wall_s=wall, prefill_s=stats["prefill_s"],
                         decode_s=stats["decode_s"], decode_steps=stats["decode_steps"],
                         peak_mem_bytes=torch.cuda.max_memory_allocated() if cuda else 0)
        saved[name] = dict(tokens=tokens,
                           logits=stats["prefill_logits"][:, :cfg.llm.vocab_size].float().cpu())
    if rank == 0:
        torch.save(saved, out / f"generate_{world}.pt")
    del model
    if world > 1:
        from mraudio_tpu_torch.device import shutdown_distributed

        shutdown_distributed()
    return res


def tp_generate_av21(out: Path, rank: int, world: int, cuda: bool) -> dict:
    """In one process of a ``world``-card launch (or alone): the published
    2.1-AV architecture (SigLIP-so400m, BEATs, Qwen2-7B in bf16) at full
    width and depth in the slice routes, seeded on this process's card in
    f32 (so every rank and the one-card run hold the same bits), cast,
    then sliced over a 1 x ``world`` mesh: 7 query heads over 1 KV head per
    rank at 4 cards; greedy on one synthetic QVH clip (378² frames, ROADMAP
    C.7).  Rank 0 saves the tokens and the first-step logits; every rank
    returns its launches, seconds, peak memory and the bytes of its f32
    logits per decode row (its vocabulary shard, and the whole row the
    gather gives it).  Without a card: the tiny VideoLLaMA with grouped-
    query attention and q/k/v biases in f32 on gloo (the rehearsal)."""
    from mraudio_tpu_torch import parallel
    from mraudio_tpu_torch.config import (DATASET_MAX_AUDIO_SECONDS, DATASET_N_FRMS,
                                          AudioFrontendConfig, MeshConfig, tiny_data_config)
    from mraudio_tpu_torch.device import init_distributed
    from mraudio_tpu_torch.models.casting import cast_params_for_inference
    from mraudio_tpu_torch.models.convert_jax import init_random_
    from mraudio_tpu_torch.models.videollama import (VideoLLaMA, tiny_videollama_config,
                                                     videollama21_av_config)

    dev = init_distributed("cuda" if cuda else "cpu") if world > 1 else torch.device(
        "cuda" if cuda else "cpu")
    route = dict(attention_impl="pallas", decode_gemv="pallas", prefill_chunk=0)
    if cuda:
        n_frms = DATASET_N_FRMS["QVH"]
        cfg = videollama21_av_config(n_frms)
        cfg = cfg.replace(llm=cfg.llm.replace(**route))
        audio_cfg = AudioFrontendConfig(max_audio_seconds=DATASET_MAX_AUDIO_SECONDS["QVH"])
        seconds = audio_cfg.max_audio_seconds
    else:
        n_frms, tiny = 4, tiny_videollama_config()
        cfg = tiny.replace(llm=tiny.llm.replace(dtype="float32", num_kv_heads=2,
                                                attention_bias=True, **route),
                           vit=tiny.vit.replace(dtype="float32"),
                           beats=tiny.beats.replace(dtype="float32"))
        audio_cfg = tiny_data_config().audio
        a = audio_cfg
        seconds = (a.hop_length * (n_frms * a.mel_frames_per_chunk - 1) + a.win_length) \
            / a.sampling_rate
    t = time.perf_counter()
    model = VideoLLaMA(cfg, audio_cfg=audio_cfg, device=dev)
    init_random_(model, seed=0)
    cast_params_for_inference(model)
    if world > 1:
        parallel.shard_module_(model, parallel.make_mesh(MeshConfig(data=1, model=world)))
    init_peak = 0
    if cuda:
        torch.cuda.synchronize()
        init_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    init_s = time.perf_counter() - t
    grid = cfg.vit.image_size // cfg.vit.patch_size * cfg.vit.patch_size
    batch = qvh_batch(1, n_frms, grid, seconds, audio_cfg.sampling_rate, seed=1)
    stats = {}
    set_launches(0)
    t = time.perf_counter()
    tokens = model.generate_submit(batch=batch, stats=stats).cpu()
    wall = time.perf_counter() - t
    launches, passes = read_launches(), stats["decode_steps"]
    attn = model.llm.layers[0].attn
    vocab = model.llm.lm_head.local_dims()[1]
    res = dict(rank=rank, world=world, init_s=init_s, init_peak_mem_bytes=init_peak,
               launches=launches, passes=passes,
               layers=cfg.llm.num_layers, heads=attn.heads, kv_heads=attn.kv_heads,
               want_launches={"flash_attention": cfg.llm.num_layers,
                              "decode_gemv": gemv_launches(cfg.llm, passes)},
               prefix_len=stats["prefix_len"], encode_s=stats["encode_s"],
               prefill_s=stats["prefill_s"], decode_s=stats["decode_s"], wall_s=wall,
               peak_mem_bytes=torch.cuda.max_memory_allocated() if cuda else 0,
               logits_f32_bytes_per_row=dict(shard=4 * vocab, gathered=4 * cfg.llm.vocab_size))
    if rank == 0:
        torch.save(dict(greedy=dict(tokens=tokens, logits=stats["prefill_logits"][
            :, :cfg.llm.vocab_size].float().cpu())), out / f"generate_av21_{world}.pt")
    del model
    if world > 1:
        from mraudio_tpu_torch.device import shutdown_distributed

        shutdown_distributed()
    return res


def _launch(mode: str, out: Path, nproc: int, args: list, timeout: int) -> list:
    """The parallel runner in ``nproc`` processes under
    ``torch.distributed.run`` (or one plain process for ``nproc=0``);
    returns each rank's readings."""
    root = Path(__file__).resolve().parent
    runner = out / "runner.py"
    runner.write_text(_PARALLEL_RUNNER)
    launcher = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc-per-node", str(nproc)] if nproc else [sys.executable])
    env = dict(os.environ, PYTHONPATH=str(root) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t = time.perf_counter()
    proc = subprocess.run([*launcher, str(runner), mode, str(out), *args], cwd=root, env=env,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"parallel {mode} on {nproc or 1} process(es) failed "
                             f"({proc.returncode}): {proc.stdout[-2000:]}{proc.stderr[-3000:]}")
    world = max(nproc, 1)
    ranks = [json.loads((out / f"{mode}_{world}_{r}.json").read_text()) for r in range(world)]
    for r in ranks:
        r["launch_wall_s"] = time.perf_counter() - t
    return ranks


def _parallel_config(out: Path, name: str, data: int, model: int, **llm) -> Path:
    from mraudio_tpu_torch.config import (DataConfig, MeshConfig, RunConfig, full_model_config,
                                          slice_model_config)

    cfg = slice_model_config(full_model_config())
    path = out / f"{name}.json"
    path.write_text(json.dumps(RunConfig(
        model=cfg.replace(llm=cfg.llm.replace(**llm)), data=DataConfig.for_dataset("QVH"),
        mesh=MeshConfig(data=data, model=model)).to_dict()))
    return path


def parallel_evaluate(out: Path, cards: int, model: str = "X-InstructBLIP") -> dict:
    """The evaluate CLI under ``torch.distributed.run`` over NCCL on
    ``cards`` cards (a ``cards`` x 1 mesh: a 1 x 1 mesh through a real
    NCCL group on one card), full width at the serving depth in the slice
    configuration, ``PARALLEL_CLIPS`` clips x ``cards`` at a global batch
    of ``cards``: every rank must launch flash and the GEMV, and the
    JSONL must equal the same CLI's without a mesh at batch 1 (each rank
    computes one row, as one card does at batch 1).  ``model="VideoLLaMA"``
    runs ``--model VideoLLaMA`` (its EVA-ViT-g + Vicuna form, the decoder
    at the same depth)."""
    clips = PARALLEL_CLIPS * cards
    gt = out / "annotations.jsonl"
    gt.write_text("".join(json.dumps(a) + "\n" for a in serve_annotations(clips)))
    common = ["--annotation-file", str(gt), "--video-source", "synthetic", "--num-workers", "1",
              "--model", model]
    mesh_cfg = _parallel_config(out, "mesh", cards, 1, num_layers=PARALLEL_LAYERS)
    one_cfg = _parallel_config(out, "one", 1, 1, num_layers=PARALLEL_LAYERS)
    ranks = _launch("evaluate", out, cards, [*common, "--config", str(mesh_cfg), "--batch-size",
                                             str(cards), "--output-file",
                                             str(out / "mesh.jsonl")], 300)
    alone = _launch("evaluate", out, 0, [*common, "--config", str(one_cfg), "--batch-size", "1",
                                         "--output-file", str(out / "one.jsonl")], 300)[0]
    result = dict(model=model, cards=cards, clips=clips, layers=PARALLEL_LAYERS, ranks=ranks,
                  one_card=alone)
    emit({"phase": "parallel_evaluate_readings", **result})
    for r in ranks:
        if not (r["launches"]["flash_attention"] > 0 and r["launches"]["decode_gemv"] > 0):
            raise AssertionError(f"parallel evaluate {model}: rank {r['rank']} launched "
                                 f"{r['launches']}")
    mesh_text, one_text = (out / "mesh.jsonl").read_text(), (out / "one.jsonl").read_text()
    if mesh_text != one_text or len(mesh_text.splitlines()) != clips:
        raise AssertionError(f"parallel evaluate {model}: the mesh JSONL differs from one "
                             "card's")
    return dict(result, jsonl_equal=True)


def _vs_one_card(a: dict, b: dict) -> dict:
    """A mesh run's tokens and first-step logits (``a``) against one
    card's (``b``): the first position where each row's tokens differ."""
    rows = [next((i for i, (x, y) in enumerate(zip(ra, rb)) if x != y), None)
            for ra, rb in zip(a["tokens"].tolist(), b["tokens"].tolist())]
    return dict(tokens_equal=bool(torch.equal(a["tokens"], b["tokens"])),
                first_differing_position=rows,
                logits_rel_l2=float((a["logits"] - b["logits"]).norm() / b["logits"].norm()),
                logits_max_abs_diff=float((a["logits"] - b["logits"]).abs().max()),
                argmax_equal=bool(torch.equal(a["logits"].argmax(-1), b["logits"].argmax(-1))))


def parallel_generate_av21(out: Path, cards: int = 4) -> dict:
    """The 2.1-AV decoder at full width and depth on a 1 x ``cards`` mesh
    (``tp_generate_av21``) against the same on one card: per rank 28
    flash launches per prefill and 197 GEMV launches per pass (and one for
    the prefill's lm_head), 7 query heads over 1 KV head at 4 cards; the
    first-step logits within ``TP_LOGIT_REL_L2`` of one card's, the first
    differing token positions reported; per-rank peak memory and decode
    seconds."""
    ranks = _launch("generate_av21", out, cards, [], 600)
    alone = _launch("generate_av21", out, 0, [], 600)[0]
    cmp = _vs_one_card(torch.load(out / f"generate_av21_{cards}.pt", weights_only=True)["greedy"],
                       torch.load(out / "generate_av21_1.pt", weights_only=True)["greedy"])
    result = dict(cards=cards, ranks=ranks, one_card=alone, vs_one_card=cmp)
    emit({"phase": "parallel_generate_av21_readings", **result})
    if not cmp["logits_rel_l2"] <= TP_LOGIT_REL_L2:
        raise AssertionError(f"parallel 2.1-AV generate: logits rel L2 {cmp['logits_rel_l2']}")
    for r in ranks + [alone]:
        if r["launches"] != r["want_launches"] or r["launches"]["flash_attention"] != 28:
            raise AssertionError(f"parallel 2.1-AV generate: rank {r['rank']} of {r['world']} "
                                 f"launched {r['launches']}, want {r['want_launches']}")
    if any((r["heads"], r["kv_heads"]) != (28 // cards, 4 // cards) for r in ranks):
        raise AssertionError(f"parallel 2.1-AV generate: heads per rank "
                             f"{[(r['heads'], r['kv_heads']) for r in ranks]}")
    return result


def parallel_generate(out: Path, cards: int = 4) -> dict:
    """Model = ``cards`` generate at full width and depth (``tp_generate``)
    against the same on one card: tokens compared (the first differing
    position reported), the first-step logits within
    ``TP_LOGIT_REL_L2``; grammar decoding at ``spec_width`` 4 and 1 must
    give identical tokens under the model axis, with and without
    ``seq_shard`` on greedy."""
    ranks = _launch("generate", out, cards, [], 400)
    alone = _launch("generate", out, 0, [], 400)[0]
    mesh = torch.load(out / f"generate_{cards}.pt", weights_only=True)
    one = torch.load(out / "generate_1.pt", weights_only=True)
    cmp = {name: _vs_one_card(mesh[name], one["grammar4" if name == "grammar4" else "greedy"])
           for name in ("greedy", "seq_shard", "grammar4")}
    result = dict(cards=cards, ranks=ranks, one_card=alone, vs_one_card=cmp)
    emit({"phase": "parallel_generate_readings", **result})
    for name, c in cmp.items():
        if not c["logits_rel_l2"] <= TP_LOGIT_REL_L2:
            raise AssertionError(f"parallel generate {name}: logits rel L2 {c['logits_rel_l2']}")
    if not torch.equal(mesh["grammar4"]["tokens"], mesh["grammar1"]["tokens"]):
        raise AssertionError("parallel generate: grammar spec_width 4 and 1 tokens differ on "
                             "the model axis")
    layers = ranks[0]["greedy"]["launches"]["flash_attention"]
    for r in ranks:
        for name in ("greedy", "seq_shard", "grammar4", "grammar1"):
            if not (r[name]["launches"]["flash_attention"] == layers > 0
                    and r[name]["launches"]["decode_gemv"] > 0):
                raise AssertionError(f"parallel generate {name}: rank {r['rank']} launched "
                                     f"{r[name]['launches']}")
    return result


def parallel_finetune(out: Path, cards: int = 4, model_name: str = "X-InstructBLIP") -> dict:
    """The finetune CLI at full width (default configuration, the depth
    cut to ``PARALLEL_LAYERS``) under ``torch.distributed.run`` on a
    data = 2 x model = 2 mesh, 4 micro-steps at a global batch of 2,
    against the same CLI on one card: losses within
    ``TP_TRAIN_LOSS_RTOL``; per-rank peak memory and wall time.
    ``model_name="VideoLLaMA"`` trains the second backbone, whose
    connector and audio projector (replicated leaves fed by the sharded
    decoder's input gradient) must move and end equal, bit for bit, on
    every rank."""
    from mraudio_tpu_torch.config import (DataConfig, MeshConfig, RunConfig, full_model_config)

    train_ann, val_ann = out / "train.jsonl", out / "val.jsonl"
    train_ann.write_text("".join(json.dumps(a) + "\n" for a in train_annotations(8)))
    val_ann.write_text("".join(json.dumps(a) + "\n" for a in train_annotations(1, 8)))
    model = full_model_config()
    model = model.replace(vit=model.vit.replace(grad_checkpoint=True),
                          llm=model.llm.replace(grad_checkpoint=True,
                                                num_layers=PARALLEL_LAYERS))
    runs = {}
    for name, mesh, nproc in (("mesh", MeshConfig(data=2, model=2), cards),
                              ("one", MeshConfig(), 0)):
        run_dir = out / f"train_{model_name}_{name}"     # a run log of its own
        config = run_dir.with_suffix(".json")
        config.write_text(json.dumps(RunConfig(model=model, data=DataConfig.for_dataset("QVH"),
                                               mesh=mesh).to_dict()))
        ranks = _launch("finetune", out, nproc, [
            "--config", str(config), "--video-source", "synthetic", "--batch-size", "2",
            "--max-epoch", "1", "--train-annotation-file", str(train_ann),
            "--val-annotation-file", str(val_ann), "--output-dir", str(run_dir),
            "--num-workers", "1", "--model", model_name], 400)
        events = [json.loads(ln) for ln in (run_dir / "train.jsonl").read_text().splitlines()]
        runs[name] = dict(ranks=ranks, losses=[e["loss"] for e in events
                                               if e["event"] == "train_step"])
    result = dict(model=model_name, cards=cards, layers=PARALLEL_LAYERS, mesh_2x2=runs["mesh"],
                  one_card=runs["one"])
    emit({"phase": "parallel_finetune_readings", **result})
    a, b = runs["mesh"]["losses"], runs["one"]["losses"]
    if len(a) != 4 or len(b) != 4 or not all(
            math.isfinite(x) and abs(x - y) <= TP_TRAIN_LOSS_RTOL * abs(y) for x, y in zip(a, b)):
        raise AssertionError(f"parallel finetune {model_name}: losses {a} against one card's {b}")
    if model_name == "VideoLLaMA":
        leaves = [r["replicated"] for r in runs["mesh"]["ranks"]]
        groups = {k.split("/")[0] for k in leaves[0]}
        if (groups != {"connector", "audio_proj"} or any(lv != leaves[0] for lv in leaves)
                or not all(v["moved"] for v in leaves[0].values())):
            raise AssertionError(f"parallel finetune VideoLLaMA: connector and projector "
                                 f"leaves per rank {leaves}")
    return result


def parallel_group() -> dict:
    """Phase 20 on every visible card up to 4: the evaluate CLI over NCCL,
    with both backbones; with 4 cards also the model = 4 generate of the
    assembly and of the 2.1-AV decoder, and the 2 x 2 finetune of both
    backbones."""
    cards = min(torch.cuda.device_count(), 4)
    root = Path(__file__).resolve().parent / "build" / "smoke_parallel"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    runs = [("evaluate", lambda: parallel_evaluate(root, cards)),
            ("videollama_evaluate", lambda: parallel_evaluate(root, cards, "VideoLLaMA"))]
    if cards >= 4:
        runs += [("generate", lambda: parallel_generate(root)),
                 ("generate_av21", lambda: parallel_generate_av21(root)),
                 ("finetune", lambda: parallel_finetune(root)),
                 ("videollama_finetune", lambda: parallel_finetune(root, 4, "VideoLLaMA"))]
    emit({"phase": "parallel_cards", "cards": cards, "runs": [name for name, _ in runs]})
    out = dict(cards=cards)
    for name, run in runs:
        t = time.perf_counter()
        out[name] = run()
        emit({"phase": f"parallel_{name}", "seconds": time.perf_counter() - t})
    shutil.rmtree(root, ignore_errors=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="also write every phase's result to this JSON file")
    ap.add_argument("--only", default="",
                    help="comma-separated phases to run (kernels, models, evaluate, serve, "
                         "converted, train, videollama, quant, parallel, spec_width); a partial "
                         "run prints no summary and no ok line")
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

    def layer(rs, counts=(4, 2, 1)):
        """One decoder layer's GEMVs (q, k, v, o, gate, up, down) from the
        readings ``rs`` of its distinct shapes, each taken ``counts`` times."""
        per_layer = [r for r, c in zip(rs, counts) for _ in range(c)]
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

        # the per-rank shapes of tensor parallelism over 2 and 4 cards: flash
        # on each rank's heads, the GEMV on each rank's column or row shard
        tp = {}
        for m in TP_WIDTHS:
            tp_flash = check_flash(dev, b, h // m, s, kv, d, gen)
            emit({"phase": "kernel", "model_axis": m, **tp_flash})
            tp_gemv = []
            for kdim, n in tp_gemv_shapes(m):
                r = check_gemv(dev, b, kdim, n, True, gen, by_cluster=False)
                emit({"phase": "kernel", "model_axis": m, **r})
                tp_gemv.append(r)
            tp[m] = dict(flash=tp_flash, gemv=tp_gemv, gemv_layer=layer(tp_gemv, (3, 1, 2, 1)))
            emit({"phase": "kernel", "name": f"decode_gemv, one decoder layer at model={m}",
                  "b3": tp[m]["gemv_layer"]})

        # the 2.1-AV decoder's per-rank shapes (its mesh path, phase 20):
        # flash on a rank's 14 or 7 query heads over 2 or 1 KV heads, the
        # bf16 GEMV at M = 1 on a rank's six shard shapes
        tp_av21 = {}
        for m in TP_WIDTHS:
            fl = av21_flash(dev, gen, m)
            emit({"phase": "kernel", "model_axis": m, "model": "av21", **fl})
            gv = []
            for kdim, n in av21_gemv_shapes(m):
                r = check_gemv(dev, 1, kdim, n, False, gen, by_cluster=False)
                emit({"phase": "kernel", "model_axis": m, "model": "av21", **r})
                gv.append(r)
            tp_av21[m] = dict(flash=fl, gemv=gv, **av21_gemv_sums(gv, (1, 2, 1, 2, 1)))
            emit({"phase": "kernel", "name": f"decode_gemv, one Qwen2 layer at model={m}",
                  "b1": tp_av21[m]["gemv_layer"], "lm_head": tp_av21[m]["gemv_lm_head"]})

        gemv_layer = layer(gemvs)
        gemv_layer_m = {m: layer(rs) for m, rs in gemvs_m.items()}
        emit({"phase": "kernel", "name": "decode_gemv, one decoder layer",
              "b3": gemv_layer, **{f"b{m}": v for m, v in gemv_layer_m.items()}})
        results["kernels"] = dict(flash=flash, flash_cases=flash_cases, gemv=gemvs,
                                  gemv_m=gemvs_m, gemv_rows=gemv_rows, gemv_rows16=gemv_rows16,
                                  gemv_other=gemv_other, per_row_attention=per_row,
                                  chunked_attention=chunked, xla_projections=xla_proj,
                                  gemv_layer=gemv_layer, gemv_layer_m=gemv_layer_m, tp=tp,
                                  tp_av21=tp_av21)
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

    if "spec_width" in only:
        t = time.perf_counter()
        model, requests = serve_model(dev)
        results["spec_width"] = spec_width_probe(model, requests)
        emit({"phase": "spec_width", **results["spec_width"], "seconds": time.perf_counter() - t})
        del model, requests
        gc.collect()
        torch.cuda.empty_cache()

    if on("converted"):
        t = time.perf_counter()
        results["converted"] = converted(dev)
        emit({"phase": "converted", **results["converted"], "seconds": time.perf_counter() - t})

    if on("train"):
        t = time.perf_counter()
        results["finetune"] = finetune_cli()
        emit({"phase": "finetune", **results["finetune"], "seconds": time.perf_counter() - t})
        gc.collect()
        torch.cuda.empty_cache()

        t = time.perf_counter()
        results["train_identities"] = train_identities(dev)
        emit({"phase": "train_identities", **results["train_identities"],
              "seconds": time.perf_counter() - t})
        gc.collect()
        torch.cuda.empty_cache()

    if on("videollama"):
        t = time.perf_counter()
        results["vl_kernels"] = videollama_kernels(dev, gen)
        emit({"phase": "videollama_kernels", **results["vl_kernels"],
              "seconds": time.perf_counter() - t})

        t = time.perf_counter()
        results["vl_evaluate"] = evaluate_cli(model="VideoLLaMA")
        emit({"phase": "videollama_evaluate", **results["vl_evaluate"],
              "seconds": time.perf_counter() - t})
        gc.collect()
        torch.cuda.empty_cache()

        t = time.perf_counter()
        results["vl_slice"] = videollama_slice(dev)
        emit({"phase": "videollama_slice", **results["vl_slice"],
              "seconds": time.perf_counter() - t})
        gc.collect()
        torch.cuda.empty_cache()

        t = time.perf_counter()
        results["vl_av21"] = videollama21_av(dev)
        emit({"phase": "videollama21_av", **results["vl_av21"],
              "seconds": time.perf_counter() - t})
        gc.collect()
        torch.cuda.empty_cache()

        t = time.perf_counter()
        results["vl_finetune"] = finetune_cli("VideoLLaMA")
        emit({"phase": "videollama_finetune", **results["vl_finetune"],
              "seconds": time.perf_counter() - t})
        gc.collect()
        torch.cuda.empty_cache()

    if on("quant"):
        for key, phase, fn in (("q_slice", "quant_slice", lambda: quant_slice(dev)),
                               ("q_evaluate", "quant_int4", quant_evaluate),
                               ("q_w8a8", "quant_w8a8", lambda: quant_w8a8(dev)),
                               ("q_serve", "quant_serve", lambda: quant_serve(dev)),
                               ("single_chip", "single_chip", single_chip_cli),
                               ("window_id", "window_identities", lambda: window_identities(dev))):
            t = time.perf_counter()
            results[key] = fn()
            emit({"phase": phase, "seconds": time.perf_counter() - t})   # readings above
            gc.collect()
            torch.cuda.empty_cache()

    if on("parallel"):
        t = time.perf_counter()
        results["parallel"] = parallel_group()
        emit({"phase": "parallel", "seconds": time.perf_counter() - t})
        gc.collect()
        torch.cuda.empty_cache()

    if args.out:
        with open(args.out, "w") as f:
            json.dump({**results, "phase_seconds": PHASE_SECONDS}, f, indent=1, default=str)
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
                                   results["serve_slice"]["spec_4"]["launches"][name],
                               "converted_generate":
                                   results["converted"]["generate"]["launches"][name],
                               "converted_evaluate":
                                   results["converted"]["evaluate"]["store"]["launches"][name],
                               "converted_serve":
                                   results["converted"]["serve"]["launches"][name],
                               "train": results["finetune"]["launches"][name],
                               "videollama_evaluate": results["vl_evaluate"]["launches"][name],
                               "videollama_slice_greedy": results["vl_slice"]["launches"][name],
                               "videollama_slice_lookup_4":
                                   results["vl_slice"]["lookup_launches"][name],
                               "videollama21_av_slice": results["vl_av21"]["launches"][name],
                               "videollama_train": results["vl_finetune"]["launches"][name],
                               "quant_slice": results["q_slice"]["launches"][name],
                               "quant_int4_evaluate": results["q_evaluate"]["launches"][name],
                               "quant_w8a8": results["q_w8a8"]["launches"][name],
                               "quant_serve": 0, "single_chip_train":
                                   results["single_chip"]["launches"][name],
                               "parallel_evaluate": sum(
                                   r["launches"][name]
                                   for r in results["parallel"]["evaluate"]["ranks"]),
                               "parallel_videollama_evaluate": sum(
                                   r["launches"][name] for r in
                                   results["parallel"]["videollama_evaluate"]["ranks"])}
                        for name in ("flash_attention", "decode_gemv")}
    vl = results["vl_kernels"]
    tp, tp_av21 = results["kernels"]["tp"], results["kernels"]["tp_av21"]

    def at(r):      # a kernel's readings at one of the VideoLLaMA shapes
        return {k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms")}

    kernels = [
        dict(name="flash_attention", route="cuda",
             source="mraudio_tpu_torch/csrc/flash_attention.cu",
             replaces="mraudio_tpu/ops/attention.py:471",
             launches=full["launches"]["flash_attention"],
             launches_by_path=launches_by_path["flash_attention"],
             max_abs_err=flash["max_abs_err"], ms=flash["ms"], plain_ms=flash["plain_ms"],
             bound_ms=flash["bound_ms"], bound_by=flash["bound_by"],
             library_ms=flash["library_ms"],
             videollama={"b4_h32_s1148": at(vl["flash_videollama"]),
                         "av21_b1_h28_kv4_s11123": at(vl["flash_av21"])},
             per_rank={**{f"model{m}_b3_h{h // m}_s{s}": at(tp[m]["flash"]) for m in TP_WIDTHS},
                       **{f"model{m}_av21_b1_h{28 // m}_kv{4 // m}_s11123":
                          at(tp_av21[m]["flash"]) for m in TP_WIDTHS}}),
        dict(name="decode_gemv", route="cuda",
             source="mraudio_tpu_torch/csrc/decode_gemv.cu",
             replaces="mraudio_tpu/ops/gemv.py:109",
             launches=full["launches"]["decode_gemv"],
             launches_by_path=launches_by_path["decode_gemv"],
             max_abs_err=max(r["max_abs_err"] for r in gemvs + sum(gemvs_m.values(), [])),
             per="one decoder layer: q,k,v,o,gate,up,down int8 at B=3",
             bound_by="bytes", **gemv_layer,
             **{f"b{m}": v for m, v in gemv_layer_m.items()},
             videollama={"av21_qwen2_layer_bf16_b1": vl["gemv_layer"],
                         "av21_lm_head_bf16_b1": vl["gemv_lm_head"],
                         "max_abs_err": max(r["max_abs_err"] for r in vl["gemv"])},
             per_rank={**{f"model{m}_layer_int8_b3": dict(
                 tp[m]["gemv_layer"], max_abs_err=max(r["max_abs_err"] for r in tp[m]["gemv"]))
                 for m in TP_WIDTHS},
                 **{f"model{m}_av21_qwen2_layer_bf16_b1": dict(
                     tp_av21[m]["gemv_layer"],
                     max_abs_err=max(r["max_abs_err"] for r in tp_av21[m]["gemv"]))
                    for m in TP_WIDTHS},
                 **{f"model{m}_av21_lm_head_bf16_b1": tp_av21[m]["gemv_lm_head"]
                    for m in TP_WIDTHS}}),
    ]
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
