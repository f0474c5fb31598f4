"""``utils/profiling.py``: :func:`annotate` names a span in a
``torch.profiler`` trace, as the JAX package's ``annotate`` names one in
a JAX trace (``jax.profiler.TraceAnnotation``), and :class:`StageTimes`
counts a stage's items and seconds."""

import torch
from torch.profiler import ProfilerActivity, profile

from mraudio_tpu_torch.utils.profiling import StageTimes, annotate


def test_annotate_names_a_span_and_stage_times_count():
    times = StageTimes()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with annotate("mraudio_span"), times.stage("encode", items=3):
            torch.ones(8).sum()
    names = {e.key for e in prof.key_averages()}
    assert {"mraudio_span", "encode"} <= names
    summary = times.summary()["encode"]
    assert summary["items"] == 3 and summary["seconds"] >= 0
    with annotate("outside a trace"):      # a no-op without a profiler
        pass
