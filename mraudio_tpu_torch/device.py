"""Device and dtype helpers shared by the port's entry points."""

from __future__ import annotations

import torch

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  Entry points default to
    ``"cuda"``; asking for CUDA without a card raises instead of running
    on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run the plain versions"
        )
    return dev
