"""Hand-worked cases for the yardstick's arithmetic: FLOP and byte counts,
the trace reduction (busy time, span device time, idle gaps) and the
per-layer readers' rates."""

import json

import pytest

from portbench import flops, harness, trace


def test_transformer_flops_by_hand():
    # 2 tokens, width 4, one layer, MLP 8: projections 2·2·(16·2 + 16·2) = 256,
    # attention 2·2·2·4·2 = 64, MLP 2·2·4·8·2 = 256
    assert flops.transformer_flops(2, 4, 1, 8) == 576


def test_flash_work_at_the_21av_prefill():
    # B 4, 28 query heads over 4 KV heads, S 11123, head 128:
    # 11123·11124/2 = 61866126 causal pairs; 4·4·28·pairs·128 operations;
    # bf16 Q, O at 28 heads and K, V at 4: 2·4·11123·128·(56 + 8) bytes
    ops, nbytes = flops.flash_work(4, 28, 4, 11123, 128)
    assert ops == 3547651129344.0
    assert nbytes == 728956928
    # bound by operations on an H100: 3.587 ms
    assert flops.least_seconds(ops, nbytes, "NVIDIA H100 80GB HBM3") == pytest.approx(
        ops / 989e12)


def test_gemv_work_bf16_and_int8():
    assert flops.gemv_work(4, 3584, 3584, 2) == (102760448, 3584 * 3584 * 2 + 8 * 7168)
    assert flops.gemv_work(4, 3584, 3584, 1)[1] == 12916736     # + the f32 scales
    assert flops.decoder_gemv_shapes({"hidden_size": 3584, "num_heads": 28, "num_kv_heads": 4,
                                      "intermediate_size": 18944}) == [
        (3584, 3584), (3584, 512), (3584, 512), (3584, 3584), (3584, 18944), (3584, 18944),
        (18944, 3584)]


@pytest.mark.parametrize("name,fn,batch_total", [
    ("xib-qwen2-7b", flops.xinstructblip_flops, 450460707479552.0),
    ("videollama2.1-7b-av", flops.videollama_flops, 857214809874432.0),
])
def test_batch_flops_at_both_configurations(name, fn, batch_total):
    cfg = json.loads((harness.PACKAGE / "configs" / f"{name}.json").read_text())
    model = cfg["videollama"] if "videollama" in cfg else cfg["program"]["model"]
    prefix = 11123 if "videollama" in cfg else 5353
    assert fn(model, cfg["program"]["data"]["audio"], 60, 4, prefix, 64) == batch_total


def test_peaks_refuse_an_unknown_card():
    assert flops.peaks_for("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    with pytest.raises(KeyError):
        flops.peaks_for("cpu")


def _event(cat, name, ts, dur, corr=None):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur, "ph": "X"}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_summary_by_hand(tmp_path):
    # window 0-100 µs; host spans encode 10-30, decode 40-90; kernels
    # launched in encode run 20-35 (a), in decode 50-60 and 55-70 (b, c);
    # a memcpy outside the window is ignored
    events = [
        _event("user_annotation", trace.WINDOW, 0, 100),
        _event("user_annotation", "encode", 10, 20),
        _event("user_annotation", "decode", 40, 50),
        _event("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
        _event("cuda_runtime", "cudaLaunchKernel", 45, 1, corr=2),
        _event("cuda_runtime", "cudaLaunchKernel", 46, 1, corr=3),
        _event("kernel", "void a_kernel<1>", 20, 15, corr=1),
        _event("kernel", "b_kernel", 50, 10, corr=2),
        _event("kernel", "c_kernel", 55, 15, corr=3),
        _event("gpu_memcpy", "Memcpy HtoD", 150, 10, corr=9),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = trace.summarize(str(path))
    assert not path.exists()
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(35e-6)              # 20-35 and 50-70
    assert s["spans"]["encode"]["device_s"] == pytest.approx(15e-6)
    assert s["spans"]["decode"]["device_s"] == pytest.approx(20e-6)
    assert s["spans"]["decode"]["wall_s"] == pytest.approx(50e-6)
    assert trace.kernel_time(s, "_kernel") == (pytest.approx(40e-6), 3)
    # gaps: 70-100 (decode until 90), 0-20 (outside), 35-50 (decode opens at 40:
    # the gap starts at 35, outside any span)
    assert s["idle_gaps"][0] == ["decode", pytest.approx(30e-6)]
    assert [g[1] for g in s["idle_gaps"]] == pytest.approx([30e-6, 20e-6, 15e-6])
    assert {n for n, _ in s["device_ops"][:2]} == {"a_kernel<1>", "c_kernel"}   # "void " cut


def _reader(name):
    return lambda record: harness.read_metric(harness.PACKAGE, name, record)


def test_window_readers_by_hand():
    record = {"device_name": "NVIDIA H100 80GB HBM3",
              "window": {"clips": 8, "batches": 2, "seconds": 20.0, "parse_write_s": 0.05,
                         "flops": 989e12 * 2.0, "clips_per_batch": 4,
                         "batch_stats": [{"decode_s": 6.4, "decode_steps": 64},
                                         {"decode_s": 3.2, "decode_steps": 32}]},
              "trace": {"window_s": 10.0, "busy_s": 4.0, "clips": 4,
                        "spans": {"encode": {"device_s": 2.0}, "prefill": {"device_s": 0.0}}}}
    assert _reader("parse_write_ms.eval")(record) == pytest.approx(25.0)
    assert _reader("decode_ms_per_pass.eval")(record) == pytest.approx(100.0)
    assert _reader("mfu_pct.eval")(record) == pytest.approx(10.0)
    assert _reader("idle_pct.eval")(record) == pytest.approx(60.0)
    assert _reader("encode_ms.eval")(record) == pytest.approx(500.0)
    assert _reader("prefill_ms.eval")(record) is None        # no device time: nothing to read
    record["device_name"] = "cpu"
    assert _reader("mfu_pct.eval")(record) is None


def test_kernel_readers_need_the_planned_launches():
    cfg = json.loads((harness.PACKAGE / "configs" / "videollama2.1-7b-av.json").read_text())
    llm = cfg["videollama"]["llm"]
    ops = {"void flash_fwd_kernel<128>": {"seconds": 28 * 0.007, "count": 28},
           "gemv_kernel": {"seconds": 1.0, "count": 2 * (7 * 28 + 1) + 1}}
    record = {"device_name": "NVIDIA H100 80GB HBM3", "config": cfg,
              "window": {"clips_per_batch": 4},
              "trace": {"ops": ops, "batches": [{"prefix_len": 11123, "decode_steps": 2}]}}
    flash = _reader("flash_roofline_pct")(record)
    assert flash == pytest.approx(3547651129344.0 / 989e12 / 0.007 * 100)
    least = sum(flops.least_seconds(*flops.gemv_work(4, k, n, 2), record["device_name"])
                for k, n in flops.decoder_gemv_shapes(llm))
    head = flops.least_seconds(*flops.gemv_work(4, 3584, 152064, 2), record["device_name"])
    assert _reader("gemv_roofline_pct")(record) == pytest.approx((2 * (28 * least + head) + head)
                                                                 * 100)
    ops["gemv_kernel"]["count"] += 1
    assert _reader("gemv_roofline_pct")(record) is None
    del ops["void flash_fwd_kernel<128>"]
    assert _reader("flash_roofline_pct")(record) is None
