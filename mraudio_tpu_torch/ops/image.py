"""Frame normalization on the device (eval preprocessing), the train-time
crop-and-flip augmentation, and the yuv420 wire format.

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


def sample_crop_params(
    rng: np.random.Generator,
    batch: int,
    height: int,
    width: int,
    min_scale: float = 0.9,
    max_scale: float = 1.0,
    ratio: tuple = (3.0 / 4.0, 4.0 / 3.0),
) -> np.ndarray:
    """Per-clip (top, left, crop_h, crop_w, flip) int32 parameters,
    sampled like torchvision's RandomResizedCrop (area scale + log
    ratio, ten tries, then the whole frame) from ``rng``: the JAX
    package's draws, in its order."""
    area = height * width
    out = np.zeros((batch, 5), dtype=np.int32)
    for i in range(batch):
        for _ in range(10):
            target_area = area * rng.uniform(min_scale, max_scale)
            log_ratio = np.log(ratio)
            aspect = np.exp(rng.uniform(*log_ratio))
            w = int(round(np.sqrt(target_area * aspect)))
            h = int(round(np.sqrt(target_area / aspect)))
            if 0 < w <= width and 0 < h <= height:
                top = rng.integers(0, height - h + 1)
                left = rng.integers(0, width - w + 1)
                out[i] = (top, left, h, w, rng.integers(0, 2))
                break
        else:
            out[i] = (0, 0, height, width, rng.integers(0, 2))
    return out


def _linear_weights(in_size: int, out_size: int, scale: torch.Tensor,
                    translation: torch.Tensor) -> torch.Tensor:
    """(in_size, out_size) f32 bilinear resampling weights of
    ``jax.image.scale_and_translate`` (triangle kernel, antialiased: the
    kernel widens by 1/scale when shrinking), each column normalized to
    sum 1 and zero where the sample falls outside the input."""
    dev = scale.device
    inv_scale = torch.ones_like(scale) / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5) * inv_scale
                - translation * inv_scale - 0.5)
    x = (sample_f[None, :] - torch.arange(in_size, dtype=torch.float32, device=dev)[:, None]
         ).abs() / kernel_scale
    weights = torch.clamp(1.0 - x.abs(), min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def augment_and_normalize(frames: torch.Tensor, crop_params: torch.Tensor, out_size: int,
                          dtype=torch.bfloat16) -> torch.Tensor:
    """Per-clip crop + horizontal flip + bilinear resize + CLIP
    normalization on the device (the reference's train transform).

    frames: (B, T, H, W, 3) uint8 (or 0..255 float, the yuv420 wire's
    RGB); crop_params: (B, 5) int (top, left, crop_h, crop_w, flip).
    Returns (B, T, out, out, 3) in ``dtype``."""
    x = frames.float() / 255.0
    b, t, h, w, c = x.shape
    params = crop_params.to(x.device)
    clips = []
    for i in range(b):
        top, left, ch, cw, flip = params[i].unbind()
        # the JAX package's f32 scale and translation of the sampling grid
        # (a number over a tensor is a reciprocal times the number in torch)
        size = torch.tensor(float(out_size), device=x.device)
        sy, sx = size / ch.float(), size / cw.float()
        ty, tx = (-top * out_size).float() / ch.float(), (-left * out_size).float() / cw.float()
        wy = _linear_weights(h, out_size, sy, ty)                    # (H, out)
        wx = _linear_weights(w, out_size, sx, tx)                    # (W, out)
        # rows first, then columns: the JAX package's contraction order
        clip = torch.einsum("tywc,wx->tyxc", torch.einsum("thwc,hy->tywc", x[i], wy), wx)
        clips.append(torch.where(flip > 0, clip.flip(2), clip))
    x = torch.stack(clips)
    mean_t = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=x.device)
    std_t = torch.tensor(CLIP_STD, dtype=torch.float32, device=x.device)
    return ((x - mean_t) / std_t).to(dtype)
