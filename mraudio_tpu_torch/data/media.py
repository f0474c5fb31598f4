"""Fabricate an on-disk media set for end-to-end runs (the JAX package's
``data/media.py``).

No media corpus ships with the repository, so runs that must read real
files fabricate them: H.264 + AAC mp4s (the codecs of the QVHighlights
corpus) with a panning textured background, a moving block and per-frame
grain, so that the encoder finds real motion and the decoder does
representative work.  They are written through the native encoder
(``native/mraudio_native.cc::mr_write_media``) and read back through the
native decode path of ``--video-source native``.

Everything is deterministic in ``seed`` (the JAX package's
``np.random.default_rng((seed, i))`` stream per video, so both packages
write the same frames, audio and annotations) and cached under ``root``
with a manifest: a second call with the same parameters rewrites nothing.
"""

from __future__ import annotations

import json
import os

import numpy as np

MANIFEST = "manifest.json"

_VERBS = [
    "opens a laptop", "pours a drink", "walks through a doorway",
    "talks to the camera", "pets a dog", "plays a guitar",
    "chops vegetables", "ties their shoes", "reads a book",
    "waves at a crowd",
]


def fabricate_frames(rng: np.random.Generator, n: int, h: int, w: int) -> np.ndarray:
    """(n, h, w, 3) uint8: a panning textured background, a moving
    foreground block and per-frame grain.  Global motion gives the encoder
    motion-estimation work; the grain keeps the bitrate (and so the decode
    cost) from collapsing to static P-frames."""
    tex = rng.integers(0, 256, (2 * h, 2 * w, 3), np.uint8)
    # smoothed a little: pure noise defeats motion estimation and inflates
    # the bitrate
    tex = (
        tex.astype(np.uint16)
        + np.roll(tex, 1, 0) + np.roll(tex, 1, 1) + np.roll(tex, 2, 1)
    ) // 4
    tex = tex.astype(np.uint8)
    bh, bw = h // 4, w // 4
    block = rng.integers(0, 256, (bh, bw, 3), np.uint8)
    out = np.empty((n, h, w, 3), np.uint8)
    phase = float(rng.uniform(0, 2 * np.pi))
    for t in range(n):
        dy = int((h // 2) * (0.5 + 0.5 * np.sin(0.013 * t + phase)))
        dx = int((w // 2) * (0.5 + 0.5 * np.cos(0.009 * t + phase)))
        frame = tex[dy : dy + h, dx : dx + w].copy()
        by = int((h - bh) * (0.5 + 0.5 * np.sin(0.05 * t + phase)))
        bx = int((w - bw) * (0.5 + 0.5 * np.cos(0.04 * t)))
        frame[by : by + bh, bx : bx + bw] = block
        grain = rng.integers(-6, 7, (h, w, 1), np.int16)
        out[t] = np.clip(frame.astype(np.int16) + grain, 0, 255).astype(np.uint8)
    return out


def fabricate_audio(rng: np.random.Generator, duration: float, sample_rate: int) -> np.ndarray:
    """A mono float32 waveform: two partials over noise under a slow
    amplitude envelope, so the AAC encoder sees non-stationary audio."""
    t = np.arange(int(duration * sample_rate), dtype=np.float32) / sample_rate
    f0 = float(rng.uniform(100, 500))
    wave = (
        0.4 * np.sin(2 * np.pi * f0 * t)
        + 0.2 * np.sin(2 * np.pi * 2.3 * f0 * t)
        + 0.15 * rng.standard_normal(len(t)).astype(np.float32)
    )
    wave *= 0.5 + 0.5 * np.sin(2 * np.pi * 0.11 * t + float(rng.uniform(0, 6)))
    return np.clip(wave, -1.0, 1.0).astype(np.float32)


def fabricate_media_set(
    root: str,
    n_videos: int = 8,
    duration: float = 150.0,
    fps: float = 24.0,
    height: int = 240,
    width: int = 320,
    queries_per_video: int = 3,
    sample_rate: int = 16000,
    gop: int = 60,
    seed: int = 0,
) -> str:
    """Write ``n_videos`` H.264+AAC mp4s and a QVH-format annotation JSONL
    (several queries per video, as in QVH) under ``root``; returns the
    annotation file's path.  Cached: if a manifest with the same
    parameters and the annotation file exist, nothing is rewritten.
    Without libav the native build raises ``NativeUnavailable``."""
    os.makedirs(root, exist_ok=True)
    params = dict(
        n_videos=n_videos, duration=duration, fps=fps, height=height,
        width=width, queries_per_video=queries_per_video,
        sample_rate=sample_rate, gop=gop, seed=seed, version=3,
    )
    ann_path = os.path.join(root, "annotations.jsonl")
    manifest_path = os.path.join(root, MANIFEST)
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            if json.load(f) == params and os.path.exists(ann_path):
                return ann_path

    from mraudio_tpu_torch.data import native_bindings as nb

    lib = nb.load()
    anns = []
    qid = 0
    for i in range(n_videos):
        rng = np.random.default_rng((seed, i))
        vid = f"media{i:03d}"
        path = os.path.join(root, vid + ".mp4")
        frames = fabricate_frames(rng, int(duration * fps), height, width)
        audio = fabricate_audio(rng, duration, sample_rate)
        nb.write_media(lib, path, frames, fps, audio, sample_rate, gop=gop)
        del frames
        for _ in range(queries_per_video):
            st = int(rng.uniform(0, max(duration - 20, 1)))
            ed = st + max(int(rng.uniform(2, min(40, duration))), 1)
            anns.append({
                "vid": vid,
                "qid": qid,
                "query": f"a person {_VERBS[qid % len(_VERBS)]}",
                # integer seconds, as QVH renders durations
                "duration": int(duration),
                "relevant_windows": [[st, min(ed, int(duration))]],
            })
            qid += 1
    with open(ann_path, "w") as f:
        for a in anns:
            f.write(json.dumps(a) + "\n")
    with open(manifest_path, "w") as f:
        json.dump(params, f)
    return ann_path
