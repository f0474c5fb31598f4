"""Frame normalization on the device (eval preprocessing)."""

from __future__ import annotations

import torch

# CLIP normalization constants (LAVIS alpro default mean/std).
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def normalize_frames(frames: torch.Tensor, dtype=torch.bfloat16,
                     mean=CLIP_MEAN, std=CLIP_STD) -> torch.Tensor:
    """uint8 (or 0..255 float) (..., H, W, 3) → normalized ``dtype``."""
    x = frames.float() / 255.0
    mean_t = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=x.device)
    return ((x - mean_t) / std_t).to(dtype)
