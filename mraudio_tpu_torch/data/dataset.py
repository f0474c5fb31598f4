"""Host-side dataset → static-shape batches with background prefetch.

* Static shapes: video is always (B, n_frms, H, W, 3) uint8, or the
  I420 wire (B, n_frms, H*3//2, W) with ``video_wire="yuv420"``
  (repeat-last-frame padding at the index level), audio a fixed-length
  int16 waveform; a short batch is padded with its last sample and
  carries a ``valid`` mask.
* uint8 video and int16 audio cross the host→device boundary;
  normalization and the fbank run on the device.
* Thread prefetch: decode is native code that releases the GIL.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import logging
import os
from typing import Iterator, Sequence

import numpy as np

from mraudio_tpu_torch.config import DataConfig
from mraudio_tpu_torch.data.annotations import load_annotations
from mraudio_tpu_torch.data.audio import AudioSource, make_audio_source
from mraudio_tpu_torch.data.sampling import frame_timestamps, sample_frame_indices
from mraudio_tpu_torch.data.video import VideoSource, make_video_source
from mraudio_tpu_torch.text.prompts import build_prompt


@dataclasses.dataclass
class Sample:
    video: np.ndarray          # (T, H, W, 3) uint8, or (T, H*3//2, W) I420
    audio: np.ndarray          # (num_samples,) int16 waveform
    timestamps: np.ndarray     # (T,) int32 seconds
    duration: float
    text_input: str
    text_output: str
    qid: object
    query: str
    vid: str


@dataclasses.dataclass
class Batch:
    video: np.ndarray          # (B, T, H, W, 3) uint8
    audio: np.ndarray          # (B, num_samples) int16
    timestamps: np.ndarray     # (B, T) int32
    duration: list
    text_input: list
    text_output: list
    qid: list
    query: list
    vid: list
    valid: np.ndarray          # (B,) bool — False for padding rows

    @property
    def size(self) -> int:
        return int(self.valid.sum())


class MRDataset:
    """Moment-retrieval dataset over a JSONL annotation file."""

    def __init__(
        self,
        cfg: DataConfig,
        annotation_path: str | None = None,
        annotations: list[dict] | None = None,
        split: str = "eval",
        video_source: VideoSource | None = None,
        audio_source: AudioSource | None = None,
        seed: int = 42,
    ):
        if cfg.video_wire not in ("rgb", "yuv420"):
            raise ValueError(f"unknown DataConfig.video_wire {cfg.video_wire!r}")
        if annotations is None:
            if annotation_path is None:
                raise ValueError("need annotation_path or annotations")
            annotations = load_annotations(annotation_path)
        self.cfg = cfg
        self.annotation = annotations
        self.split = split
        self.sampling = "random" if split == "train" else "uniform"
        self.video_source = video_source or make_video_source(cfg.video_source)
        # the audio source follows the video source
        self.audio_source = audio_source or make_audio_source(
            "synthetic" if cfg.video_source == "synthetic" else "native"
        )
        self._seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.annotation)

    @property
    def audio_num_samples(self) -> int:
        a = self.cfg.audio
        total_mel_frames = self.cfg.n_frms * a.mel_frames_per_chunk
        full = a.hop_length * (total_mel_frames - 1) + a.win_length
        if a.max_audio_seconds > 0:
            cap = int(a.max_audio_seconds * a.sampling_rate)
            # round down to a whole mel frame so fbank shapes stay exact
            cap = a.hop_length * max((cap - a.win_length) // a.hop_length, 1) + a.win_length
            return min(full, cap)
        return full

    def video_path(self, ann: dict) -> str:
        return os.path.join(self.cfg.video_folder, ann["vid"] + ".mp4")

    def get(self, index: int, strict: bool = False) -> Sample:
        """Fetch one sample.  A decode failure falls back to a black clip
        and silence with a logged warning (``strict=True`` re-raises)."""
        try:
            return self._get(index)
        except Exception:
            if strict:
                raise
            logging.getLogger("mraudio_tpu_torch").warning(
                "decode failed for %s; substituting blank sample",
                self.annotation[index].get("vid"), exc_info=True,
            )
            return self._blank_sample(index)

    def _blank_sample(self, index: int) -> Sample:
        ann = self.annotation[index]
        size = self.cfg.image_size
        if self.cfg.video_wire == "yuv420":
            # black in I420: Y = 0, U = V = 128
            vid = np.zeros((self.cfg.n_frms, size * 3 // 2, size), np.uint8)
            vid[:, size:, :] = 128
        else:
            vid = np.zeros((self.cfg.n_frms, size, size, 3), np.uint8)
        return Sample(
            video=vid,
            audio=np.zeros(self.audio_num_samples, np.int16),
            timestamps=np.zeros(self.cfg.n_frms, np.int32),
            duration=ann["duration"],
            text_input=build_prompt(self.cfg.prompt_style, ann["query"], ann["duration"]),
            text_output=str(ann["relevant_windows"]),
            qid=ann["qid"],
            query=ann["query"],
            vid=ann["vid"],
        )

    def _get(self, index: int) -> Sample:
        ann = self.annotation[index]
        path = self.video_path(ann)

        # sub-clip bounds: a decode-time seek window
        start = float(ann["start"]) if "start" in ann else None
        end = float(ann["end"]) if "end" in ann else None

        vlen, fps = self.video_source.probe(path)
        if start is not None and end is not None:
            vlen = max(int((end - start) * fps), 1)

        # Per-sample generator: deterministic given (seed, epoch, index)
        # and safe under BatchLoader's thread pool.
        rng = np.random.default_rng((self._seed, self.epoch, index))
        indices = sample_frame_indices(vlen, self.cfg.n_frms, self.sampling, rng=rng)
        get = (self.video_source.get_batch_i420 if self.cfg.video_wire == "yuv420"
               else self.video_source.get_batch)
        frames = get(path, indices, self.cfg.image_size, self.cfg.image_size, start, end)
        waveform = self.audio_source.load(
            path, self.audio_num_samples, self.cfg.audio.sampling_rate
        )
        waveform = np.clip(waveform * 32767.0, -32768, 32767).astype(np.int16)
        stamps = np.asarray(frame_timestamps(indices, fps), dtype=np.int32)

        return Sample(
            video=frames,
            audio=waveform,
            timestamps=stamps,
            duration=ann["duration"],
            text_input=build_prompt(self.cfg.prompt_style, ann["query"], ann["duration"]),
            text_output=str(ann["relevant_windows"]),
            qid=ann["qid"],
            query=ann["query"],
            vid=ann["vid"],
        )


def collate(samples: Sequence[Sample], batch_size: int) -> Batch:
    """Stack samples, padding to ``batch_size`` by repeating the last
    sample (masked out via ``valid``) so device shapes never change."""
    n = len(samples)
    if not 0 < n <= batch_size:
        raise ValueError(f"collate: {n} samples for a batch of {batch_size}")
    padded = list(samples) + [samples[-1]] * (batch_size - n)
    return Batch(
        video=np.stack([s.video for s in padded]),
        audio=np.stack([s.audio for s in padded]),
        timestamps=np.stack([s.timestamps for s in padded]),
        duration=[s.duration for s in padded],
        text_input=[s.text_input for s in padded],
        text_output=[s.text_output for s in padded],
        qid=[s.qid for s in padded],
        query=[s.query for s in padded],
        vid=[s.vid for s in padded],
        valid=np.arange(batch_size) < n,
    )


class BatchLoader:
    """Iterate a dataset in fixed-size batches with threaded prefetch."""

    def __init__(
        self,
        dataset: MRDataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 42,
        num_threads: int = 2,
        prefetch_depth: int = 2,
        drop_last: bool = False,
        shard_index: int = 0,
        shard_count: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_threads = num_threads
        self.prefetch_depth = max(prefetch_depth, 1)
        self.drop_last = drop_last
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self.dataset.epoch = epoch

    def _order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        return order[self.shard_index :: self.shard_count]

    def __len__(self) -> int:
        n = len(self._order())
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Batch]:
        return self.iter_from(0)

    def iter_from(self, start_batch: int) -> Iterator[Batch]:
        """Iterate from batch ordinal ``start_batch`` without building the
        skipped batches; the order is deterministic in (seed, epoch)."""
        order = self._order()
        n_batches = len(self)
        starts = [i * self.batch_size for i in range(start_batch, n_batches)]

        def build(start: int) -> Batch:
            idxs = order[start : start + self.batch_size]
            samples = [self.dataset.get(int(i)) for i in idxs]
            return collate(samples, self.batch_size)

        with concurrent.futures.ThreadPoolExecutor(self.num_threads) as pool:
            pending = [pool.submit(build, s) for s in starts[: self.prefetch_depth]]
            next_submit = self.prefetch_depth
            for _ in range(len(starts)):
                batch = pending.pop(0).result()
                if next_submit < len(starts):
                    pending.append(pool.submit(build, starts[next_submit]))
                    next_submit += 1
                yield batch
