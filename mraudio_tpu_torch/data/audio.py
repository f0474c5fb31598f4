"""Audio waveform sources.  The host produces a fixed-length mono
waveform; the mel fbank runs on the device (``ops/fbank.py``)."""

from __future__ import annotations

import hashlib

import numpy as np


class AudioSource:
    def load(self, path: str, num_samples: int, sample_rate: int) -> np.ndarray:
        """Return float32 mono waveform of exactly ``num_samples`` at
        ``sample_rate`` (truncate / zero-pad as needed)."""
        raise NotImplementedError


class SyntheticAudioSource(AudioSource):
    """Deterministic multi-tone waveform keyed on the path hash."""

    def load(self, path: str, num_samples: int, sample_rate: int) -> np.ndarray:
        seed = int.from_bytes(hashlib.sha1(path.encode()).digest()[:4], "little")
        t = np.arange(num_samples, dtype=np.float32) / sample_rate
        f0 = 110.0 * (1 + seed % 8)
        wave = (
            0.5 * np.sin(2 * np.pi * f0 * t)
            + 0.3 * np.sin(2 * np.pi * 2.7 * f0 * t + 0.1 * seed)
            + 0.1 * np.sin(2 * np.pi * 0.5 * t) * np.sin(2 * np.pi * 5.3 * f0 * t)
        )
        return wave.astype(np.float32)


class NativeAudioSource(AudioSource):
    """libav demux + swresample to mono at ``sample_rate``
    (``data/native_bindings.py``)."""

    def __init__(self):
        from mraudio_tpu_torch.data import native_bindings

        self._lib = native_bindings.load()

    def load(self, path: str, num_samples: int, sample_rate: int) -> np.ndarray:
        from mraudio_tpu_torch.data import native_bindings

        # decode only the samples consumed (the C loop stops once `out`
        # is full)
        wave = native_bindings.decode_audio(
            self._lib, path, sample_rate,
            max_seconds=num_samples / sample_rate + 1.0,
        )
        if len(wave) >= num_samples:
            return wave[:num_samples]
        return np.pad(wave, (0, num_samples - len(wave)))


def make_audio_source(kind: str) -> AudioSource:
    if kind == "synthetic":
        return SyntheticAudioSource()
    if kind == "native":
        return NativeAudioSource()
    raise ValueError(f"unknown audio source kind {kind!r}")
