"""Frame normalization on the device (eval preprocessing) and the yuv420
wire format.

The ``yuv420`` wire ships a frame's I420 planes (limited-range BT.601:
Y 16..235, U/V 16..240, what the codec emits for untagged web video)
packed as one uint8 (..., H*3/2, W) array: half the bytes of RGB24.
:func:`rgb_to_yuv420` packs RGB on the host (numpy; the same bytes as the
JAX package's); :func:`yuv420_to_rgb` rebuilds RGB on the device, which
:func:`normalize_frames` then takes.
"""

from __future__ import annotations

import numpy as np
import torch

# CLIP normalization constants (LAVIS alpro default mean/std).
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

_YUV_FROM_RGB = np.array(
    [
        [0.299, 0.587, 0.114],
        [-0.168736, -0.331264, 0.5],
        [0.5, -0.418688, -0.081312],
    ],
    np.float32,
)
_Y_SCALE = 219.0 / 255.0   # full-range Y -> limited 16..235
_C_SCALE = 224.0 / 255.0   # full-range chroma offset -> limited 16..240


def normalize_frames(frames: torch.Tensor, dtype=torch.bfloat16,
                     mean=CLIP_MEAN, std=CLIP_STD) -> torch.Tensor:
    """uint8 (or 0..255 float) (..., H, W, 3) → normalized ``dtype``."""
    x = frames.float() / 255.0
    mean_t = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=x.device)
    return ((x - mean_t) / std_t).to(dtype)


def rgb_to_yuv420(frames: np.ndarray) -> np.ndarray:
    """Host packing: uint8 RGB (..., H, W, 3) → uint8 (..., H*3//2, W):
    the I420 memory layout viewed as rows (Y at full resolution, then U
    and V, each the mean of 2×2 boxes, as H/4 rows of width W).  H and W
    must be multiples of 4."""
    lead, (h, w, _) = frames.shape[:-3], frames.shape[-3:]
    yuv = frames.astype(np.float32) @ _YUV_FROM_RGB.T
    y = yuv[..., 0] * _Y_SCALE + 16.0
    u = yuv[..., 1] * _C_SCALE + 128.0
    v = yuv[..., 2] * _C_SCALE + 128.0
    u = u.reshape(lead + (h // 2, 2, w // 2, 2)).mean(axis=(-3, -1))
    v = v.reshape(lead + (h // 2, 2, w // 2, 2)).mean(axis=(-3, -1))
    packed = np.concatenate(
        [y, u.reshape(lead + (h // 4, w)), v.reshape(lead + (h // 4, w))], axis=-2)
    return np.clip(np.rint(packed), 0, 255).astype(np.uint8)


def yuv420_to_rgb(wire: torch.Tensor) -> torch.Tensor:
    """Device unpacking: uint8 (..., H*3//2, W) limited-range I420 → f32
    RGB (..., H, W, 3) in 0..255, chroma repeated over its 2×2 box."""
    lead, (hp, w) = wire.shape[:-2], wire.shape[-2:]
    h = hp * 2 // 3
    q = h // 4
    y = (wire[..., :h, :].float() - 16.0) / _Y_SCALE
    u = wire[..., h:h + q, :].float().reshape(lead + (h // 2, w // 2))
    v = wire[..., h + q:, :].float().reshape(lead + (h // 2, w // 2))
    u = (u.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1) - 128.0) / _C_SCALE
    v = (v.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1) - 128.0) / _C_SCALE
    r = y + 1.402 * v
    g = y - 0.344136 * u - 0.714136 * v
    b = y + 1.772 * u
    return torch.stack([r, g, b], dim=-1).clamp(0.0, 255.0)
