"""Kaldi-compatible log-mel filterbank frontend on the device.

Semantics of ``torchaudio.compliance.kaldi.fbank`` as BEATs uses it:
snip-edges framing (a gather), per-frame DC removal, 0.97 preemphasis
with x[-1] := x[0], povey window, power spectrum over a next-power-of-two
rFFT, kaldi mel banks over [20 Hz, Nyquist], natural log with a float-eps
floor; then BEATs mean/std normalization and pad-or-trim to per-frame
chunks.
"""

from __future__ import annotations

import numpy as np
import torch

from mraudio_tpu_torch.config import AudioFrontendConfig

BEATS_FBANK_MEAN = 15.41663
BEATS_FBANK_STD = 6.55582

_FLT_EPS = 1.1920928955078125e-07  # float32 machine epsilon (kaldi's floor)


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def povey_window(win_length: int) -> np.ndarray:
    n = np.arange(win_length, dtype=np.float64)
    hann = 0.5 - 0.5 * np.cos(2 * np.pi * n / (win_length - 1))
    return (hann ** 0.85).astype(np.float32)


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)


def kaldi_mel_banks(num_bins: int, n_fft: int, sample_rate: int,
                    low_freq: float = 20.0, high_freq: float = 0.0) -> np.ndarray:
    """Triangular mel filterbank matrix (num_fft_bins, num_bins) with
    kaldi's mel-domain interpolation."""
    if high_freq <= 0.0:
        high_freq = sample_rate / 2.0 + high_freq
    num_fft_bins = n_fft // 2 + 1
    mel_low = mel_scale(low_freq)
    mel_high = mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    fft_freqs = np.arange(num_fft_bins, dtype=np.float64) * sample_rate / n_fft
    mel_freqs = mel_scale(fft_freqs)
    left = mel_low + np.arange(num_bins)[:, None] * mel_delta
    center = left + mel_delta
    right = center + mel_delta
    up = (mel_freqs[None, :] - left) / (center - left)
    down = (right - mel_freqs[None, :]) / (right - center)
    weights = np.maximum(0.0, np.minimum(up, down))
    return weights.T.astype(np.float32)


def kaldi_fbank(waveform: torch.Tensor, *, win_length: int = 400,
                hop_length: int = 160, num_mel_bins: int = 128,
                sample_rate: int = 16000, preemphasis: float = 0.97,
                remove_dc: bool = True) -> torch.Tensor:
    """(B, N) float32 waveform → (B, M, num_mel_bins) float32 log-mels,
    M = 1 + (N - win) // hop."""
    b, n = waveform.shape
    dev = waveform.device
    num_frames = 1 + (n - win_length) // hop_length
    n_fft = _next_pow2(win_length)

    idx = (torch.arange(num_frames, device=dev)[:, None] * hop_length
           + torch.arange(win_length, device=dev)[None, :])
    frames = waveform[:, idx]                                # (B, M, win)
    if remove_dc:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = frames - preemphasis * prev
    frames = frames * torch.from_numpy(povey_window(win_length)).to(dev)
    pad = n_fft - win_length
    if pad:
        frames = torch.nn.functional.pad(frames, (0, pad))
    spectrum = torch.fft.rfft(frames, dim=-1)
    power = spectrum.real.square() + spectrum.imag.square()  # (B, M, F)
    banks = torch.from_numpy(kaldi_mel_banks(num_mel_bins, n_fft, sample_rate)).to(dev)
    mel = power @ banks
    return torch.log(mel.clamp_min(_FLT_EPS))


def beats_frontend(waveform: torch.Tensor, cfg: AudioFrontendConfig,
                   n_frms: int) -> torch.Tensor:
    """Waveform → (B, n_frms, mel_frames_per_chunk, num_mel_bins)
    normalized fbank chunks.  Integer waveforms are taken as int16-range;
    float waveforms are scaled by 32768."""
    if waveform.is_floating_point():
        scaled = waveform.float() * 32768.0
    else:
        scaled = waveform.float()
    fbank = kaldi_fbank(
        scaled, win_length=cfg.win_length, hop_length=cfg.hop_length,
        num_mel_bins=cfg.num_mel_bins, sample_rate=cfg.sampling_rate,
        preemphasis=cfg.preemphasis,
    )
    fbank = (fbank - BEATS_FBANK_MEAN) / (2 * BEATS_FBANK_STD)
    b, m, k = fbank.shape
    total = n_frms * cfg.mel_frames_per_chunk
    if m < total:
        fbank = torch.nn.functional.pad(fbank, (0, 0, 0, total - m))
    else:
        fbank = fbank[:, :total]
    return fbank.reshape(b, n_frms, cfg.mel_frames_per_chunk, k)
