"""Throughput instrumentation.

* :func:`annotate` opens a named span of a ``torch.profiler`` trace (the
  JAX package's ``jax.profiler.TraceAnnotation``); every span of the
  program is opened through it, and only on the thread that launches the
  device work (the loader's worker threads open none);
* :class:`StageTimes` aggregates per-stage host seconds and item counts
  (clips/s per stage); each stage is also an :func:`annotate` span;
* :func:`profile_to` captures a ``torch.profiler`` trace of a block and
  writes it to ``<logdir>/trace.json`` (chrome trace format: open it in
  Perfetto or ``chrome://tracing``).

The spans, the map of a ``--profile-dir`` trace; a device operation
belongs to the innermost span whose host code launched it.  Each name is
followed by the benchmark metric (``portbench/metrics/``) that reads it:

* ``load`` (``infer/evaluate.py::run_inference``): waiting for the
  loader's next batch and copying it to the device, once per batch and
  once more for the end of the stream; ``load_ms.eval``;
* ``generate`` and ``parse_write`` (:class:`StageTimes` stages of
  ``run_inference``): ``generate_submit`` and ``generate_finalize``;
  ``parse_write_ms.eval`` reads the stage's host seconds;
* ``encode`` (``generate_submit`` of both backbones, and the trainer's
  split encode): the prompt, the encoders and the prefix;
  ``encode_ms.eval``;

  * ``encode.video``, inside it: the video tower (wire decode,
    normalisation, EVA-ViT-g or SigLIP, then the Q-Former and projection
    or the connector); ``encode_video_ms.eval``;
  * ``encode.audio``, inside it: fbank, BEATs, then the Q-Former and
    projection or the audio projector; ``encode_audio_ms.eval``;

* ``prefill`` (``infer/generate.py``): the prefix through the decoder
  into the cache; ``prefill_ms.eval``;
* ``decode`` (each decoder of ``infer/generate.py``): the decode loop;
  ``decode_ms_per_pass.eval`` reads its ``decode_s`` stat;

  * ``decode.pass``, inside it: the host code that launches one model
    pass and its token bookkeeping, once per pass;
    ``decode_launch_ms_per_pass.eval`` (host time) and
    ``decode_device_ms_per_pass.eval`` (device time launched);
  * ``decode.sync``, inside it: the per-pass check that every row has
    finished, where the host waits for the device;
    ``decode_sync_ms_per_pass.eval``;

* ``loss_fwd_bwd`` and ``optimizer`` (``train/trainer.py``): one
  micro-step's loss and gradients, and the update; no benchmark cell
  trains yet, so no metric reads them.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time

from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def annotate(name: str):
    """A named span over the block in a ``torch.profiler`` trace."""
    with record_function(name):
        yield


class StageTimes:
    def __init__(self):
        self.seconds: dict[str, float] = collections.defaultdict(float)
        self.counts: dict[str, int] = collections.defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0):
        with annotate(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.seconds[name] += time.perf_counter() - t0
                self.counts[name] += items

    def throughput(self, name: str) -> float:
        sec = self.seconds.get(name, 0.0)
        return self.counts.get(name, 0) / sec if sec > 0 else 0.0

    def summary(self) -> dict:
        return {
            name: {
                "seconds": round(self.seconds[name], 4),
                "items": self.counts[name],
                "items_per_sec": round(self.throughput(name), 4),
            }
            for name in self.seconds
        }


@contextlib.contextmanager
def profile_to(logdir: str, cuda: bool):
    """Trace the block (host activity, and the card's with ``cuda``) into
    ``logdir/trace.json``."""
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
