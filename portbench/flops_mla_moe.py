"""The matmul FLOPs of one VideoLLaMA evaluation batch with a DeepSeek-V3
decoder (latent attention and routed experts), at the shapes the program
runs them.  Counts are 2 per multiply-accumulate; elementwise work, the
norms and the rope are left out.

Per batch row, over a ``prefill_len``-token prefix and ``decode_steps``
decode passes:

* the towers, the connector and the audio projector: ``flops.py``'s;
* per token and layer: ``q_proj``, ``kv_a_proj_with_mqa``, ``o_proj``; in
  the prefill also ``kv_b_proj`` (each prefix column decompressed once)
  and the causal attention over the prefill_len·(prefill_len + 1)/2
  (query, key) pairs at 192-wide queries and keys and 128-wide values;
  in a decode pass the absorbed form: each head's query through W_UK
  and its weighted latent through W_UV, and the attention over the
  latent (576-wide logits, 512-wide weighted sums) across the columns
  written so far (the prefix and the pass's own tokens);
* the MLP: the dense layers' SwiGLU at ``intermediate_size``; an expert
  layer's router (hidden x experts), its ``num_experts_per_tok`` chosen
  experts and its shared experts, each a SwiGLU (not all the experts);
* the lm_head at the prefill's last position and at every decode pass.
"""

from __future__ import annotations

from portbench import flops


def _token_layer(llm: dict, layer: int) -> float:
    """Projection and MLP FLOPs of one token through one layer, without
    ``kv_b_proj`` and the attention itself."""
    d, h, r = llm["hidden_size"], llm["num_heads"], llm["kv_lora_rank"]
    nope, rope, vd = llm["qk_nope_head_dim"], llm["qk_rope_head_dim"], llm["v_head_dim"]
    proj = 2 * d * (h * (nope + rope) + r + rope) + 2 * h * vd * d
    if llm["n_routed_experts"] and layer >= llm["first_k_dense_replace"]:
        width = llm["moe_intermediate_size"]
        mlp = (2 * d * llm["n_routed_experts"]
               + 3 * 2 * d * width * (llm["num_experts_per_tok"] + llm["n_shared_experts"]))
    else:
        mlp = 3 * 2 * d * llm["intermediate_size"]
    return proj + mlp


def decoder_flops(llm: dict, prefill_len: int, decode_steps: int) -> float:
    """One batch row's decoder FLOPs: the prefill and its last-position
    lm_head, then ``decode_steps`` passes with their lm_heads."""
    h, r = llm["num_heads"], llm["kv_lora_rank"]
    nope, rope, vd = llm["qk_nope_head_dim"], llm["qk_rope_head_dim"], llm["v_head_dim"]
    layers = range(llm["num_layers"])
    per_token = sum(_token_layer(llm, i) for i in layers)
    head = 2 * llm["hidden_size"] * llm["vocab_size"]
    s = prefill_len
    pairs = s * (s + 1) / 2
    prefill = (s * per_token + llm["num_layers"] * (
        s * 2 * r * h * (nope + vd) + pairs * 2 * h * (nope + rope + vd)) + head)
    # pass t attends the prefix and its own t + 1 tokens
    columns = decode_steps * s + decode_steps * (decode_steps + 1) / 2
    absorb = 2 * h * nope * r + 2 * h * r * vd
    decode = (decode_steps * (per_token + llm["num_layers"] * absorb + head)
              + llm["num_layers"] * columns * 2 * h * (r + rope + r))
    return prefill + decode


def batch_flops(model: dict, audio: dict, n_frms: int, batch: int, prefill_len: int,
                decode_steps: int) -> float:
    """One generate batch of ``batch`` clips (``flops.videollama_flops``'s
    towers and connector, this module's decoder)."""
    vit, beats, llm = model["vit"], model["beats"], model["llm"]
    _, _, f_vit, f_beats = flops._encoders(vit, beats, audio, n_frms, batch)
    patches = (vit["image_size"] // vit["patch_size"]) ** 2
    v_tok = (n_frms // model["temporal_stride"]) * (patches // model["spatial_pool"] ** 2)
    d = llm["hidden_size"]
    f_conn = batch * 2 * (v_tok * (vit["width"] * d + d * d)
                          + n_frms * (beats["width"] * d + d * d))
    return f_vit + f_beats + f_conn + batch * decoder_flops(llm, prefill_len, decode_steps)
