"""Video frame sources, all returning uint8 (T, H, W, 3) frames, or with
``get_batch_i420`` the I420 wire layout (T, H*3//2, W); normalization
happens on the device (``ops/image.py``).

* :class:`NativeVideoSource`: the libav decoder of ``native/`` (bound by
  ``data/native_bindings.py``): seekable decode, fps/frame-count probe,
  batched index gather with swscale resize into a caller buffer;
* :class:`SyntheticVideoSource`: procedural frames keyed on the path
  hash (tests, chip runs: no video corpus ships with the repo);
* :class:`NpyVideoSource`: pre-extracted ``.npy`` frame stacks.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np


class VideoSource:
    """Protocol: probe + batched frame gather."""

    def probe(self, path: str) -> tuple[int, float]:
        """Return (num_frames, fps)."""
        raise NotImplementedError

    def get_batch(
        self,
        path: str,
        indices: np.ndarray,
        height: int,
        width: int,
        start: float | None = None,
        end: float | None = None,
    ) -> np.ndarray:
        """Decode ``indices`` (frame numbers relative to the
        [start, end) sub-clip if given) resized to (height, width).
        Returns uint8 (T, H, W, 3)."""
        raise NotImplementedError

    def get_batch_i420(self, path, indices, height, width, start=None, end=None):
        """Like :meth:`get_batch` in the I420 wire layout (T, H*3//2, W)
        uint8 (``video_wire="yuv420"``): the RGB decode packed on the
        host; the native source copies the codec planes instead."""
        from mraudio_tpu_torch.ops.image import rgb_to_yuv420

        return rgb_to_yuv420(self.get_batch(path, indices, height, width, start, end))


class SyntheticVideoSource(VideoSource):
    """Deterministic procedural video: smooth moving gradients keyed on
    the path hash, so two reads of the same path agree and different
    clips differ.  ``vlen``/``fps`` derive from the hash too unless fixed
    in the constructor."""

    def __init__(self, vlen: int | None = None, fps: float | None = None):
        self._vlen = vlen
        self._fps = fps

    def _seed(self, path: str) -> int:
        return int.from_bytes(hashlib.sha1(path.encode()).digest()[:4], "little")

    def probe(self, path: str) -> tuple[int, float]:
        seed = self._seed(path)
        vlen = self._vlen if self._vlen is not None else 120 + seed % 240
        fps = self._fps if self._fps is not None else float(24 + seed % 7)
        return vlen, fps

    def get_batch(self, path, indices, height, width, start=None, end=None):
        seed = self._seed(path)
        t = np.asarray(indices, dtype=np.float32)[:, None, None, None]
        yy = np.linspace(0, 1, height, dtype=np.float32)[None, :, None, None]
        xx = np.linspace(0, 1, width, dtype=np.float32)[None, None, :, None]
        phase = (seed % 628) / 100.0
        chan = np.arange(3, dtype=np.float32)[None, None, None, :]
        img = 0.5 + 0.5 * np.sin(
            2 * np.pi * (0.02 * t + yy + 0.5 * xx + 0.3 * chan) + phase
        )
        return (img * 255).astype(np.uint8)


class NpyVideoSource(VideoSource):
    """Reads ``{root}/{vid}.npy`` uint8 (T, H, W, 3) stacks at
    ``default_fps``."""

    def __init__(self, root: str, default_fps: float = 30.0):
        self.root = root
        self.default_fps = default_fps

    def _path(self, path: str) -> str:
        if os.path.isabs(path) and os.path.exists(path):
            return path
        return os.path.join(self.root, path)

    def probe(self, path: str) -> tuple[int, float]:
        arr = np.load(self._path(path), mmap_mode="r")
        return arr.shape[0], self.default_fps

    def get_batch(self, path, indices, height, width, start=None, end=None):
        arr = np.load(self._path(path), mmap_mode="r")
        frames = np.asarray(arr[np.asarray(indices)])
        if frames.shape[1] != height or frames.shape[2] != width:
            frames = _resize_nearest(frames, height, width)
        return frames


def _resize_nearest(frames: np.ndarray, height: int, width: int) -> np.ndarray:
    t, h, w, c = frames.shape
    ys = (np.arange(height) * h // height).clip(0, h - 1)
    xs = (np.arange(width) * w // width).clip(0, w - 1)
    return frames[:, ys[:, None], xs[None, :], :]


class NativeVideoSource(VideoSource):
    """libav-backed decoder (``native/mraudio_native.cc``)."""

    def __init__(self):
        from mraudio_tpu_torch.data import native_bindings

        self._lib = native_bindings.load()

    def probe(self, path: str) -> tuple[int, float]:
        from mraudio_tpu_torch.data import native_bindings

        return native_bindings.probe(self._lib, path)

    def get_batch(self, path, indices, height, width, start=None, end=None):
        from mraudio_tpu_torch.data import native_bindings

        return native_bindings.decode_frames(
            self._lib, path, np.asarray(indices, dtype=np.int64), height, width,
            start if start is not None else -1.0,
            end if end is not None else -1.0,
        )

    def get_batch_i420(self, path, indices, height, width, start=None, end=None):
        from mraudio_tpu_torch.data import native_bindings

        return native_bindings.decode_frames_i420(
            self._lib, path, np.asarray(indices, dtype=np.int64), height, width,
            start if start is not None else -1.0,
            end if end is not None else -1.0,
        )


def make_video_source(kind: str, **kwargs) -> VideoSource:
    if kind == "synthetic":
        return SyntheticVideoSource(
            vlen=kwargs.get("vlen"), fps=kwargs.get("fps")
        )
    if kind == "npy":
        return NpyVideoSource(root=kwargs.get("root", ""))
    if kind == "native":
        return NativeVideoSource()
    raise ValueError(f"unknown video source kind {kind!r}")
