"""DeepSeek-V3's expert layer, for decoder layers from
``LlamaConfig.first_k_dense_replace`` on when ``n_routed_experts`` > 0:
``transformers``' ``models/deepseek_v3/modeling_deepseek_v3.py``
(``DeepseekV3TopkRouter``, ``DeepseekV3MoE``) with one expert group
(``n_group`` 1, Kimi-VL-A3B's).  The JAX package has no such layer.

* The router, in f32: logits ``x · router.kernel`` (stored (hidden,
  experts) and widened), sigmoid scores.  The choice is the top
  ``num_experts_per_tok`` of the scores plus ``router.bias`` (the
  published ``e_score_correction_bias``, which only chooses); each
  chosen expert's weight is its unbiased score, over the chosen scores'
  sum + 1e-20 with ``norm_topk_prob``, times ``routed_scaling_factor``.
* The routed experts as stacked SwiGLU weights, allocated in the serving
  dtype: ``experts.gate_up`` (hidden, experts, 2 x width), gate columns
  then up columns, and ``experts.down`` (width, experts, hidden), input
  first like every dense kernel of the port.  They take no quantized
  format: ``llama.py::refuse_unsupported`` refuses ``quantization``.
* The dispatch: the (token, slot) pairs sorted by expert, each expert's
  rows one group of a grouped product per projection
  (``torch._grouped_mm``), the groups' ends found by ``searchsorted`` on
  the device.  No count reaches the host, so the layer never waits for
  the device; the published code asks ``numel() > 0`` of every expert,
  one host synchronisation each.
* The combine: each pair's output times its weight, summed per token in
  f32 over its slots, rounded to the model dtype, plus the shared experts
  (one SwiGLU of width ``n_shared_experts`` x ``moe_intermediate_size``,
  a ``LlamaMlp``, so a decode pass takes the GEMV route there).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mraudio_tpu_torch.config import LlamaConfig
from mraudio_tpu_torch.device import torch_dtype
from mraudio_tpu_torch.models.layers import _empty
from mraudio_tpu_torch.models.llama import LlamaMlp


class ExpertCounters:
    """Routing counters of one batch, kept on the device: per MoE layer in
    a decode pass the number of distinct experts its tokens read, and per
    MoE layer in a prefill its largest per-expert token count over the
    mean count.  :meth:`read` copies them to the host in one transfer."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.distinct, self.decode_layers, self.imbalance = None, 0, None

    def add(self, counts: torch.Tensor, decode: bool) -> None:
        """``counts``: one layer call's (experts,) token counts.  After the
        first decode call the distinct count grows in place, so a replayed
        CUDA graph of a decode pass (``infer/generate.py``) adds to it."""
        if decode:
            n = (counts > 0).sum()
            if self.distinct is None:
                self.distinct = n
            else:
                self.distinct.add_(n)
            self.decode_layers += 1
        else:
            r = counts.max() / counts.float().mean()
            self.imbalance = r if self.imbalance is None else torch.maximum(self.imbalance, r)

    def read(self) -> dict:
        """``moe_decode_experts`` (distinct experts per MoE layer per decode
        pass, the mean) and ``moe_prefill_imbalance`` (the largest
        per-expert token count of any MoE layer of the prefill over the
        mean count), for what was counted."""
        names = [k for k, v in (("moe_decode_experts", self.distinct),
                                ("moe_prefill_imbalance", self.imbalance)) if v is not None]
        if not names:
            return {}
        vals = torch.stack([v.float() for v in (self.distinct, self.imbalance)
                            if v is not None]).tolist()
        out = dict(zip(names, vals))
        if "moe_decode_experts" in out:
            out["moe_decode_experts"] /= self.decode_layers
        return out


class ExpertKernel(nn.Module):
    """One stacked projection of every routed expert: (in, experts, out)."""

    def __init__(self, in_features: int, experts: int, features: int, cfg: LlamaConfig):
        super().__init__()
        self.dtype = torch_dtype(cfg.dtype)
        self.kernel = _empty(in_features, experts, features, dtype=self.dtype)

    def forward(self, rows: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
        """(M, in) rows sorted by expert, expert ``e``'s ending at
        ``ends[e]`` (int32) → (M, out) in the model dtype."""
        dt = self.dtype
        return torch._grouped_mm(rows.to(dt), self.kernel.to(dt).transpose(0, 1), offs=ends)


class Router(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.kernel = _empty(cfg.hidden_size, cfg.n_routed_experts)
        # e_score_correction_bias: chooses the experts, weighs nothing
        self.bias = _empty(cfg.n_routed_experts)

    def forward(self, x2: torch.Tensor):
        """(T, hidden) → ((T, k) expert ids, (T, k) f32 weights)."""
        cfg = self.cfg
        scores = (x2.float() @ self.kernel.float()).sigmoid()
        ids = (scores + self.bias.float()).topk(cfg.num_experts_per_tok, dim=-1,
                                                sorted=False).indices
        weights = scores.gather(1, ids)
        if cfg.norm_topk_prob:
            weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
        return ids, weights * cfg.routed_scaling_factor


class MoeMlp(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        e, width = cfg.n_routed_experts, cfg.moe_intermediate_size
        self.router = Router(cfg)
        self.experts = nn.Module()
        self.experts.gate_up = ExpertKernel(cfg.hidden_size, e, 2 * width, cfg)
        self.experts.down = ExpertKernel(width, e, cfg.hidden_size, cfg)
        self.shared_experts = LlamaMlp(cfg.replace(
            intermediate_size=cfg.n_shared_experts * width), None)
        self.counters: ExpertCounters | None = None      # set by LlamaModel

    def forward(self, x: torch.Tensor, decode: bool = False) -> torch.Tensor:
        """(B, S, hidden) → (B, S, hidden) in the model dtype; ``decode``
        says which counter the call's expert counts go to."""
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        k, width = cfg.num_experts_per_tok, cfg.moe_intermediate_size
        x2 = x.reshape(-1, x.shape[-1])
        ids, weights = self.router(x2)
        flat = ids.reshape(-1)
        order = torch.argsort(flat, stable=True)                          # pairs by expert
        experts = torch.arange(cfg.n_routed_experts, device=x.device)
        ends = torch.searchsorted(flat[order], experts, right=True).to(torch.int32)
        h = self.experts.gate_up(x2.index_select(0, order // k), ends)
        y = self.experts.down(F.silu(h[:, :width]) * h[:, width:], ends)
        back = torch.empty_like(order).scatter_(0, order, torch.arange(
            order.numel(), device=x.device))
        y = y.index_select(0, back).view(-1, k, x.shape[-1])               # (T, k, hidden)
        routed = (y.float() * weights[..., None]).sum(dim=1).to(dt)
        if self.counters is not None:
            self.counters.add(torch.diff(ends, prepend=ends.new_zeros(1)), decode)
        return routed.view(x.shape) + self.shared_experts(x)
