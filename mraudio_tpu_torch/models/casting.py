"""Parameter casting for inference: matmul and embedding weights become
bf16; norm scales/biases, quantization scales and int8 weights keep
their dtype.  The same name rule as the JAX package, applied to the
module's dotted parameter names."""

from __future__ import annotations

import torch
from torch import nn

_KEEP_FP32 = ("scale", "bias")
_KEEP_FP32_SCOPES = ("norm", "ln", "LayerNorm")


def keeps_dtype(name: str, param: torch.Tensor) -> bool:
    names = name.split(".")
    if not param.is_floating_point():
        return True
    if names[-1] in _KEEP_FP32 and any(
        any(s in n for s in _KEEP_FP32_SCOPES) for n in names[:-1]
    ):
        return True
    return names[-1] == "scale" or names[-1].endswith("_scale")


@torch.no_grad()
def cast_params_for_inference(module: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """Cast ``module``'s parameters in place; returns ``module``."""
    for name, p in module.named_parameters():
        if not keeps_dtype(name, p):
            p.data = p.data.to(dtype)
    return module
