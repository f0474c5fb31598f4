"""Q-Former: BERT-style encoder over [learned queries ; instruction
text], with cross-attention from the query positions into the frozen
encoder's output every ``cross_attention_freq``-th layer and separate
feed-forward weights for query and text positions."""

from __future__ import annotations

import torch
from torch import nn

from mraudio_tpu_torch.config import QFormerConfig
from mraudio_tpu_torch.device import torch_dtype
from mraudio_tpu_torch.models.layers import (
    Attention, Embed, LayerNormFp32, Mlp, _empty, make_padding_mask,
)


class QFormerLayer(nn.Module):
    def __init__(self, cfg: QFormerConfig, has_cross_attention: bool,
                 encoder_width: int, dtype: torch.dtype):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.self_attn = Attention(d, cfg.num_heads, dtype=dtype)
        self.self_norm = LayerNormFp32(d, eps)
        self.has_cross_attention = has_cross_attention
        if has_cross_attention:
            self.cross_attn = Attention(d, cfg.num_heads, kv_features=encoder_width, dtype=dtype)
            self.cross_norm = LayerNormFp32(d, eps)
        self.mlp_query = Mlp(d, cfg.intermediate_size, dtype=dtype)
        self.ffn_norm_query = LayerNormFp32(d, eps)
        self.mlp_text = Mlp(d, cfg.intermediate_size, dtype=dtype)
        self.ffn_norm_text = LayerNormFp32(d, eps)

    def forward(self, x, self_mask, encoder_states, encoder_mask, query_length):
        x = self.self_norm(x + self.self_attn(x, mask=self_mask))
        queries, text = x[:, :query_length], x[:, query_length:]
        if self.has_cross_attention:
            h = self.cross_attn(queries, kv=encoder_states, mask=encoder_mask)
            queries = self.cross_norm(queries + h)
        queries = self.ffn_norm_query(queries + self.mlp_query(queries))
        if text.shape[1] > 0:
            text = self.ffn_norm_text(text + self.mlp_text(text))
        return torch.cat([queries, text], dim=1)


class QFormer(nn.Module):
    def __init__(self, cfg: QFormerConfig, encoder_width: int):
        super().__init__()
        self.cfg = cfg
        self.dtype = torch_dtype(cfg.dtype)
        self.word_embeddings = Embed(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = _empty(cfg.max_position_embeddings, cfg.hidden_size)
        self.embeddings_norm = LayerNormFp32(cfg.hidden_size, cfg.layer_norm_eps)
        self.layers = nn.ModuleList(
            QFormerLayer(cfg, i % cfg.cross_attention_freq == 0, encoder_width, self.dtype)
            for i in range(cfg.num_layers)
        )

    def forward(self, query_embeds, input_ids, attention_mask,
                encoder_hidden_states, encoder_attention_mask=None):
        """query_embeds (N, Q, H); input_ids/attention_mask (N, L);
        encoder_hidden_states (N, S, E).  Returns (N, Q+L, H)."""
        dt = self.dtype
        n, q_len, _ = query_embeds.shape
        l_len = input_ids.shape[1]
        word = self.word_embeddings(input_ids)
        text = (word + self.position_embeddings[:l_len][None]).to(dt)
        # zero padded text positions (a garbage embedding there would
        # reach the output through 0·NaN in probs @ values)
        text = text * attention_mask[..., None].to(dt)
        x = self.embeddings_norm(torch.cat([query_embeds.to(dt), text], dim=1))

        joint_mask = torch.cat(
            [attention_mask.new_ones((n, q_len)), attention_mask], dim=1)
        self_mask = make_padding_mask(joint_mask)
        if encoder_attention_mask is None:
            enc_mask = None
        else:
            enc_mask = make_padding_mask(encoder_attention_mask)
        enc = encoder_hidden_states.to(dt)
        for layer in self.layers:
            x = layer(x, self_mask, enc, enc_mask, q_len)
        return x
