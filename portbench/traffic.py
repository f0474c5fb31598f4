"""The one traffic generator: annotations from a mix's parameters and
``--seed``, and the clips they name.

A mix (``portbench/traffic/<name>.json``) states the clip count per
batch and the query, duration and window shapes.  Every seed draws the
same sizes (fixed-length query strings and video ids, one duration) in
other contents, so two seeds ask the same work of the program.

The clip behind an annotation is the synthetic QVHighlights clip that
the program's ``synthetic`` media source renders for its video id (a
frozen copy of that rendering is :func:`clip_inputs`): the benchmark
hands the program only the annotations, and the reference renders the
same frames, waveform, frame times and prompt from them.
"""

from __future__ import annotations

import hashlib

import numpy as np

WORDS = ("a", "man", "woman", "child", "dog", "cat", "walks", "talks", "runs", "along", "the",
         "beach", "street", "kitchen", "camera", "slowly", "red", "blue", "jacket", "ball",
         "sunset", "market", "bike", "rides", "opens", "door", "window", "shows", "food",
         "plays", "guitar", "river", "boat", "near", "two", "people", "dance", "cooks")
TASK_PROMPT = "Given the video and the query, find the relevant windows.\nRelevant windows: "


def annotations(mix: dict, seed: int, count: int, first: int = 0) -> list[dict]:
    """``count`` annotations drawn from ``seed``; ``first`` offsets their
    ordinals, so the warm-up's and the window's never share a clip."""
    out = []
    for i in range(first, first + count):
        rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), i])
        words, text = [], ""
        while len(text) < mix["query_chars"]:
            words.append(WORDS[int(rng.integers(len(WORDS)))])
            text = " ".join(words)
        query = text[:mix["query_chars"]].rstrip().ljust(mix["query_chars"], "s")
        vid = "v" + rng.bytes(8).hex()[:mix["vid_chars"] - 1]
        duration = int(mix["duration"])
        start = int(rng.integers(0, duration - mix["window"]))
        out.append({"qid": i, "vid": vid, "query": query, "duration": duration,
                    "relevant_windows": [[start, start + int(mix["window"])]]})
    return out


# ----------------------------------------------------------------------
# The program's synthetic clip, frozen (``data/video.py``,
# ``data/audio.py``, ``data/sampling.py``, ``data/dataset.py``)
# ----------------------------------------------------------------------


def _path_seed(path: str) -> int:
    return int.from_bytes(hashlib.sha1(path.encode()).digest()[:4], "little")


def audio_num_samples(audio: dict, n_frms: int) -> int:
    hop = int(audio["sampling_rate"] * audio["frame_shift_ms"] / 1000)
    win = int(audio["sampling_rate"] * audio["frame_length_ms"] / 1000)
    full = hop * (n_frms * audio["mel_frames_per_chunk"] - 1) + win
    if audio["max_audio_seconds"] > 0:
        cap = int(audio["max_audio_seconds"] * audio["sampling_rate"])
        cap = hop * max((cap - win) // hop, 1) + win
        return min(full, cap)
    return full


def clip_inputs(ann: dict, data: dict) -> dict:
    """The clip of ``ann`` as the data config reads it: ``frames`` uint8
    (T, H, W, 3), ``wave`` int16 (N,), ``timestamps`` (T,) int seconds,
    ``duration`` and ``prompt``."""
    path = ann["vid"] + ".mp4"
    seed = _path_seed(path)
    vlen, fps = 120 + seed % 240, float(24 + seed % 7)
    n_frms, size = data["n_frms"], data["image_size"]
    num = min(n_frms, vlen)
    idx = np.linspace(0, vlen, num=num, endpoint=False).astype(int)
    idx = np.concatenate([idx, np.full(n_frms - num, idx[-1])]) if num < n_frms else idx
    t = idx.astype(np.float32)[:, None, None, None]
    yy = np.linspace(0, 1, size, dtype=np.float32)[None, :, None, None]
    xx = np.linspace(0, 1, size, dtype=np.float32)[None, None, :, None]
    chan = np.arange(3, dtype=np.float32)[None, None, None, :]
    img = 0.5 + 0.5 * np.sin(2 * np.pi * (0.02 * t + yy + 0.5 * xx + 0.3 * chan)
                             + (seed % 628) / 100.0)
    frames = (img * 255).astype(np.uint8)

    audio = data["audio"]
    n = audio_num_samples(audio, n_frms)
    ts = np.arange(n, dtype=np.float32) / audio["sampling_rate"]
    f0 = 110.0 * (1 + seed % 8)
    wave = (0.5 * np.sin(2 * np.pi * f0 * ts)
            + 0.3 * np.sin(2 * np.pi * 2.7 * f0 * ts + 0.1 * seed)
            + 0.1 * np.sin(2 * np.pi * 0.5 * ts) * np.sin(2 * np.pi * 5.3 * f0 * ts)
            ).astype(np.float32)
    wave = np.clip(wave * 32767.0, -32768, 32767).astype(np.int16)
    stamps = [round(float(i) / fps) for i in idx]
    return {"frames": frames, "wave": wave, "timestamps": stamps,
            "duration": ann["duration"],
            "prompt": "Query: " + ann["query"] + "\n" + TASK_PROMPT}
