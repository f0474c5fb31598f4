"""The readers of the program's inner spans (``load``, ``encode.video``,
``encode.audio``, ``decode.pass``, ``decode.sync``) by hand on synthetic
records, the cases with nothing sound to read included, and one traced
tiny run on the CPU that reports the three read from host time."""

import json
import time

import pytest
import torch

from portbench import harness

SPAN_METRICS = ("load_ms.eval", "encode_video_ms.eval", "encode_audio_ms.eval",
                "decode_launch_ms_per_pass.eval", "decode_device_ms_per_pass.eval",
                "decode_sync_ms_per_pass.eval")
HOST_METRICS = ("load_ms.eval", "decode_launch_ms_per_pass.eval", "decode_sync_ms_per_pass.eval")
XIB = {"program": {"model": {"max_new_tokens": 64}}}
VL = {"program": {"model": {"max_new_tokens": 8}}, "videollama": {"max_new_tokens": 64}}


def _span(device_s, wall_s, count):
    return {"device_s": device_s, "wall_s": wall_s, "count": count}


def _record(config=XIB, **changes):
    """Two traced batches of 4 clips: one that spent the 64-token budget
    (64 passes, 64 checks), one whose rows finished after 10 passes (11
    checks)."""
    spans = {"encode": _span(2.0, 2.1, 2), "decode": _span(6.0, 9.0, 2),
             "load": _span(0.0, 3.0, 3), "encode.video": _span(0.8, 0.9, 2),
             "encode.audio": _span(0.4, 0.5, 2), "decode.pass": _span(3.7, 7.4, 74),
             "decode.sync": _span(0.0, 1.48, 75)}
    spans.update(changes)
    spans = {k: v for k, v in spans.items() if v is not None}
    return {"trace": {"spans": spans, "clips": 8,
                      "batches": [{"decode_steps": 64}, {"decode_steps": 10}]},
            "config": config}


def _read(name, record):
    return harness.read_metric(harness.PACKAGE, name, record)


def test_readers_by_hand():
    r = _record()
    assert _read("load_ms.eval", r) == pytest.approx(1500.0)          # 3 s over 2 batches
    assert _read("encode_video_ms.eval", r) == pytest.approx(100.0)   # 0.8 s over 8 clips
    assert _read("encode_audio_ms.eval", r) == pytest.approx(50.0)
    assert _read("decode_launch_ms_per_pass.eval", r) == pytest.approx(100.0)  # 7.4 s / 74
    assert _read("decode_device_ms_per_pass.eval", r) == pytest.approx(50.0)
    assert _read("decode_sync_ms_per_pass.eval", r) == pytest.approx(20.0)     # 1.48 s / 74
    # VideoLLaMA's budget is its own config's
    assert _read("decode_sync_ms_per_pass.eval", _record(VL)) == pytest.approx(20.0)


@pytest.mark.parametrize("name,span", [
    ("load_ms.eval", "load"), ("encode_video_ms.eval", "encode.video"),
    ("encode_audio_ms.eval", "encode.audio"), ("decode_launch_ms_per_pass.eval", "decode.pass"),
    ("decode_device_ms_per_pass.eval", "decode.pass"),
    ("decode_sync_ms_per_pass.eval", "decode.sync")])
def test_nothing_to_read_without_the_span(name, span):
    assert _read(name, _record(**{span: None})) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_nothing_to_read_in_a_trace_without_inner_spans(name):
    """A program without the inner spans: its traced record has only the
    outer ones, and its untraced record no trace."""
    record = _record(**{s: None for s in ("load", "encode.video", "encode.audio",
                                          "decode.pass", "decode.sync")})
    assert _read(name, record) is None
    assert _read(name, {"trace": None, "config": XIB}) is None


@pytest.mark.parametrize("name,span", [
    ("encode_video_ms.eval", "encode.video"), ("encode_audio_ms.eval", "encode.audio"),
    ("decode_device_ms_per_pass.eval", "decode.pass")])
def test_nothing_to_read_without_device_time(name, span):
    record = _record()
    record["trace"]["spans"][span]["device_s"] = 0.0        # the CPU launches no kernel
    assert _read(name, record) is None


@pytest.mark.parametrize("name,span,count", [
    ("load_ms.eval", "load", 2),                    # batches + 1 = 3
    ("encode_video_ms.eval", "encode.video", 3),    # one per batch
    ("encode_audio_ms.eval", "encode.audio", 1),
    ("decode_launch_ms_per_pass.eval", "decode.pass", 75),      # summed decode_steps = 74
    ("decode_device_ms_per_pass.eval", "decode.pass", 73),
    ("decode_sync_ms_per_pass.eval", "decode.sync", 74),        # 64 + 10 + 1 = 75
    ("decode_sync_ms_per_pass.eval", "decode.sync", 76)])
def test_nothing_to_read_when_the_count_misses_the_plan(name, span, count):
    record = _record()
    record["trace"]["spans"][span]["count"] = count
    assert _read(name, record) is None


def test_traced_tiny_run_reports_the_host_span_metrics(data_root):
    bench = json.loads((harness.PACKAGE.parent / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        m.pop("workloads", None)
    rc, line = harness.execute(data_root, bench, "tiny-xib-eval", 2 ** 35 + 3, True,
                               torch.device("cpu"), time.perf_counter(), "build/portbench-test")
    assert rc == 0 and line["correct"]
    metrics = line["metrics"]
    assert all(metrics[name]["value"] > 0 and metrics[name]["unit"] == "ms"
               for name in HOST_METRICS)
    # no device time on the CPU: the device readers have nothing to read
    assert not {"encode_video_ms.eval", "encode_audio_ms.eval",
                "decode_device_ms_per_pass.eval"} & set(metrics)
