"""The yardstick's arithmetic: the card's peaks, the matmul FLOPs of a
whole evaluation batch, and the operations and bytes each hand-written
kernel's work needs.

Frozen copies of the program's ``utils/flops.py`` (``transformer_flops``,
``pipeline_flops``, ``videollama_flops``), so that a change to the
program cannot move the yardstick.  Counts are 2 per multiply-accumulate;
elementwise work is left out (bound by memory, under 1% of the matmuls
at these widths).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense (no sparsity), at its 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
PEAKS = {"H100": (PEAK_BF16_FLOPS, PEAK_BYTES_PER_S)}


def peaks_for(device_name: str) -> tuple[float, float]:
    """(bf16 FLOP/s, bytes/s) of the card ``device_name`` names; a card
    the table does not know raises rather than give a share of a guess."""
    for key, val in PEAKS.items():
        if key.lower() in device_name.lower():
            return val
    raise KeyError(f"no peak known for {device_name!r}; known: {sorted(PEAKS)}")


def transformer_flops(tokens: int, width: int, depth: int, mlp_dim: int,
                      kv_len: float | None = None, kv_width: int | None = None,
                      n_mlp_mats: int = 2) -> float:
    """Forward matmul FLOPs of a transformer stack over ``tokens``
    positions, each attending ``kv_len`` columns (default ``tokens``)."""
    kv_len = tokens if kv_len is None else kv_len
    kv_width = width if kv_width is None else kv_width
    proj = 2 * tokens * (width * width * 2 + width * kv_width * 2)
    attn = 2 * tokens * kv_len * width * 2
    mlp = 2 * tokens * width * mlp_dim * n_mlp_mats
    return depth * (proj + attn + mlp)


def _vit_tokens(vit: dict) -> int:
    return (vit["image_size"] // vit["patch_size"]) ** 2 + int(vit["use_class_token"])


def _encoders(vit: dict, beats: dict, audio: dict, n_frms: int, batch: int) -> tuple:
    p_tok = _vit_tokens(vit)
    f_embed = 2 * p_tok * (vit["patch_size"] ** 2 * 3) * vit["width"]
    f_vit = batch * n_frms * (transformer_flops(p_tok, vit["width"], vit["depth"],
                                                vit["mlp_dim"]) + f_embed)
    a_tok = ((audio["mel_frames_per_chunk"] // beats["patch_stride"])
             * (beats["num_mel_bins"] // beats["patch_stride"]))
    f_beats = batch * n_frms * (
        transformer_flops(a_tok, beats["width"], beats["depth"], beats["mlp_dim"])
        + 2 * a_tok * beats["patch_size"] ** 2 * beats["conv_dim"])
    return p_tok, a_tok, f_vit, f_beats


def _decoder(llm: dict, batch: int, prefill_len: int, decode_tokens: int) -> tuple:
    d, heads = llm["hidden_size"], llm["num_heads"]
    kv_w = llm["num_kv_heads"] * (d // heads)
    f_prefill = batch * transformer_flops(prefill_len, d, llm["num_layers"],
                                          llm["intermediate_size"], kv_len=prefill_len / 2,
                                          kv_width=kv_w, n_mlp_mats=3)
    f_prefill += batch * 2 * d * llm["vocab_size"]
    avg_ctx = prefill_len + decode_tokens / 2
    f_decode = batch * decode_tokens * (
        transformer_flops(1, d, llm["num_layers"], llm["intermediate_size"], kv_len=avg_ctx,
                          kv_width=kv_w, n_mlp_mats=3)
        + 2 * d * llm["vocab_size"])
    return f_prefill, f_decode


def xinstructblip_flops(model: dict, audio: dict, n_frms: int, batch: int, prefill_len: int,
                        decode_tokens: int) -> float:
    """One X-InstructBLIP generate batch (``pipeline_flops``): EVA-ViT and
    BEATs over the folded frames and chunks, both Q-Formers, the decoder's
    prefill (last-position lm_head) and ``decode_tokens`` decode passes."""
    vit, beats, qf = model["vit"], model["beats"], model["qformer"]
    p_tok, a_tok, f_vit, f_beats = _encoders(vit, beats, audio, n_frms, batch)
    q = qf["num_query_tokens"]
    qf_tokens = q + model["max_txt_len"] // 4
    n_cross = qf["num_layers"] // qf["cross_attention_freq"]
    f_qf = 0.0
    for enc_tok, enc_w in ((p_tok, vit["width"]), (a_tok, beats["width"])):
        f_qf += batch * n_frms * (
            transformer_flops(qf_tokens, qf["hidden_size"], qf["num_layers"],
                              qf["intermediate_size"])
            + n_cross * (2 * enc_tok * enc_w * qf["hidden_size"] * 2
                         + 2 * q * enc_tok * qf["hidden_size"] * 2))
    f_prefill, f_decode = _decoder(model["llm"], batch, prefill_len, decode_tokens)
    return f_vit + f_beats + f_qf + f_prefill + f_decode


def videollama_flops(model: dict, audio: dict, n_frms: int, batch: int, prefill_len: int,
                     decode_tokens: int) -> float:
    """One VideoLLaMA generate batch (``videollama_flops``): the folded ViT
    and BEATs, the connector and the audio projector, the prefill and the
    decode passes."""
    vit, beats, llm = model["vit"], model["beats"], model["llm"]
    _, _, f_vit, f_beats = _encoders(vit, beats, audio, n_frms, batch)
    patches = (vit["image_size"] // vit["patch_size"]) ** 2
    v_tok = (n_frms // model["temporal_stride"]) * (patches // model["spatial_pool"] ** 2)
    d = llm["hidden_size"]
    f_conn = batch * 2 * (v_tok * (vit["width"] * d + d * d)
                          + n_frms * (beats["width"] * d + d * d))
    f_prefill, f_decode = _decoder(llm, batch, prefill_len, decode_tokens)
    return f_vit + f_beats + f_conn + f_prefill + f_decode


BATCH_FLOPS = {"xinstructblip": xinstructblip_flops, "videollama": videollama_flops}


def flash_work(batch: int, heads: int, kv_heads: int, seq: int, head_dim: int) -> tuple:
    """(operations, bytes) the causal flash forward over a ``seq``-token
    prefix needs: QK^T and PV over the seq·(seq+1)/2 causal pairs of each
    head; Q and O at ``heads`` heads and K and V at ``kv_heads`` heads,
    each read or written once in bf16."""
    pairs = seq * (seq + 1) / 2
    ops = 2 * 2 * batch * heads * pairs * head_dim
    nbytes = 2 * batch * seq * head_dim * (2 * heads + 2 * kv_heads)
    return ops, nbytes


def gemv_work(rows: int, k: int, n: int, weight_bytes: int) -> tuple:
    """(operations, bytes) of y = x @ w for ``rows`` rows: the weight read
    once, x read and y written once in bf16 (plus an f32 scale per column
    for int8 weights)."""
    ops = 2 * rows * k * n
    nbytes = k * n * weight_bytes + 2 * rows * (k + n) + (4 * n if weight_bytes == 1 else 0)
    return ops, nbytes


def decoder_gemv_shapes(llm: dict) -> list[tuple[int, int]]:
    """(K, N) of one decoder layer's seven projections, in launch order."""
    d, heads = llm["hidden_size"], llm["num_heads"]
    hd = d // heads
    kv = llm["num_kv_heads"] * hd
    inter = llm["intermediate_size"]
    return [(d, heads * hd), (d, kv), (d, kv), (heads * hd, d), (d, inter), (d, inter),
            (inter, d)]


def least_seconds(ops: float, nbytes: float, device_name: str) -> float:
    """The roofline bound: the larger of operations over the bf16 peak and
    bytes over the memory bandwidth."""
    flops, bw = peaks_for(device_name)
    return max(ops / flops, nbytes / bw)
