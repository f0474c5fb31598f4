"""The plain reference against the port at tiny sizes on the CPU, the
frozen clip rendering against the program's loader, and whole tiny runs:
sound ones come out correct, and each fault the cells can have, planted
where the program produces it, comes out not correct."""

import json
import time

import numpy as np
import pytest
import torch

from portbench import harness, traffic, weights
from portbench.entries import run_inference as entry
from portbench.reference import common

SEED = 2 ** 33 + 17
CELLS = ("tiny-xib-eval", "tiny-vl-eval")


def _ctx(data_root, cell):
    return harness.context(data_root, cell, SEED, False, torch.device("cpu"),
                           time.perf_counter(), "build/portbench-test")


def _bench():
    bench = json.loads((harness.PACKAGE.parent / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        m.pop("workloads", None)
    return bench


def _run(data_root, cell, trace=False):
    return harness.execute(data_root, _bench(), cell, SEED, trace, torch.device("cpu"),
                           time.perf_counter(), "build/portbench-test")


@pytest.mark.parametrize("cell", CELLS)
def test_clip_rendering_matches_the_loader(data_root, cell):
    from mraudio_tpu_torch.config import DataConfig
    from mraudio_tpu_torch.data.dataset import MRDataset

    ctx = _ctx(data_root, cell)
    data = ctx.config["program"]["data"]
    anns = traffic.annotations(ctx.mix, SEED, 3)
    ds = MRDataset(DataConfig.from_dict(data), annotations=anns, split="eval")
    for i, ann in enumerate(anns):
        clip, sample = traffic.clip_inputs(ann, data), ds.get(i, strict=True)
        assert np.array_equal(clip["frames"], sample.video)
        assert np.array_equal(clip["wave"], sample.audio)
        assert clip["timestamps"] == sample.timestamps.tolist()
        assert clip["prompt"] == sample.text_input and clip["duration"] == sample.duration


def test_annotations_share_their_sizes_across_seeds(data_root):
    mix = _ctx(data_root, "tiny-xib-eval").mix
    a, b = traffic.annotations(mix, 1, 4), traffic.annotations(mix, 2 ** 40, 4)
    assert [len(x["query"]) for x in a + b] == [mix["query_chars"]] * 8
    assert {len(x["vid"]) for x in a + b} == {mix["vid_chars"]}
    assert a != b and a == traffic.annotations(mix, 1, 4)


def test_weights_repeat_from_the_seed():
    spec = [("a.kernel", (3, 5), torch.float32), ("a.w_int8", (4, 2), torch.int8),
            ("a.scale", (2,), torch.float32), ("n.norm.scale", (7,), torch.bfloat16)]
    one, two = weights.make(spec, SEED, "cpu"), weights.make(spec, SEED, "cpu")
    assert all(torch.equal(one[k], two[k]) for k in one)
    assert not torch.equal(one["a.kernel"], weights.make(spec, SEED + 1, "cpu")["a.kernel"])
    assert one["a.scale"].min() > 0 and one["a.w_int8"].abs().max() <= 127


@pytest.mark.parametrize("cell", CELLS)
def test_reference_follows_the_port(data_root, cell):
    """The port's decoder inputs and first-step logits against the
    reference's, on one clip: the port computes in bf16, so within a bf16
    network's relative error."""
    ctx = _ctx(data_root, cell)
    run_cfg, model = entry._build(ctx.config, torch.device("cpu"))
    spec = weights.spec_of(model)
    weights.fill_module_(model, SEED)
    data = ctx.config["program"]["data"]
    ann = traffic.annotations(ctx.mix, SEED, 1)[0]
    clip = traffic.clip_inputs(ann, data)
    video = torch.from_numpy(clip["frames"])[None]
    wave = torch.from_numpy(clip["wave"])[None]
    from mraudio_tpu_torch.models.xinstructblip import GenerateBatch

    batch = GenerateBatch(video=video.numpy(), audio=wave.numpy(),
                          timestamps=np.asarray([clip["timestamps"]]),
                          duration=[clip["duration"]], text_input=[clip["prompt"]])
    stats = {}
    with torch.inference_mode():
        pending = model.generate_submit(batch=batch, stats=stats)
    tokens = (pending[0] if isinstance(pending, tuple) else pending)[0].numpy()
    served = tokens[:entry._served_len(tokens)].tolist()
    w = common.Weights(weights.make(spec, SEED, "cpu"))
    ref = ctx.reference_module()
    with torch.no_grad():
        logits = ref.served_logits(w, entry._model_dict(ctx.config), data["audio"],
                                   dict(clip, frames=video[0], wave=wave[0]), served)
    first = stats["prefill_logits"][0, :logits.shape[1]].float()
    rel = float((first - logits[0]).norm() / logits[0].norm())
    assert rel < 0.05
    gap = logits.max(-1).values - logits.gather(1, torch.tensor(served)[:, None])[:, 0]
    first, ref = first - first.mean(), logits[0] - logits[0].mean()
    readings = {"logit_gap": float(gap.max()),
                "logit_rel_err": float((first - ref).norm() / ref.norm())}
    assert all(readings[k] <= limit for k, limit in ctx.cell["limits"].items())


@pytest.mark.parametrize("cell", CELLS)
def test_sound_tiny_run_is_correct(data_root, cell):
    rc, line = _run(data_root, cell)
    assert rc == 0 and line["correct"], line["checks"]
    assert line["attempted"] >= 2 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"clips_per_s", "setup_s", "peak_mem_gib"}


def test_traced_tiny_run_reads_its_metrics(data_root):
    rc, line = _run(data_root, "tiny-vl-eval", trace=True)
    assert rc == 0 and line["correct"]
    assert {"parse_write_ms.eval", "decode_ms_per_pass.eval"} <= set(line["metrics"])
    assert "breakdown" in line and line["device"]["window_s"] > 0


def _alter_token(monkeypatch, module):
    from mraudio_tpu_torch.infer import generate

    def greedy(*args, **kwargs):
        out = generate.greedy_generate(*args, **kwargs)
        out[:, 1] = torch.where(out[:, 1] == 40, 41, 40)      # a byte that is not EOS
        return out

    monkeypatch.setattr(module, "greedy_generate", greedy)


@pytest.mark.parametrize("cell,module", [
    ("tiny-xib-eval", "mraudio_tpu_torch.models.xinstructblip"),
    ("tiny-vl-eval", "mraudio_tpu_torch.models.videollama")])
def test_a_token_altered_where_produced_fails(data_root, monkeypatch, cell, module):
    import importlib

    _alter_token(monkeypatch, importlib.import_module(module))
    rc, line = _run(data_root, cell)
    assert rc == 0 and not line["correct"]
    name = next(iter(_ctx(data_root, cell).cell["limits"]))
    assert line["checks"][name]["value"] > line["checks"][name]["limit"]


def test_an_answer_altered_where_produced_fails(data_root, monkeypatch):
    from mraudio_tpu_torch.text.tokenizer import ByteTokenizer

    decode = ByteTokenizer.batch_decode
    monkeypatch.setattr(ByteTokenizer, "batch_decode",
                        lambda self, b, skip_special_tokens=True: [
                            t + "]" for t in decode(self, b, skip_special_tokens)])
    rc, line = _run(data_root, "tiny-xib-eval")
    assert not line["correct"] and line["checks"]["text_mismatches"]["value"] > 0


def test_clips_left_out_fail(data_root, monkeypatch):
    from mraudio_tpu_torch.data import dataset

    collate = dataset.collate

    def half(samples, batch_size):
        b = collate(samples, batch_size)
        b.valid[batch_size // 2:] = False
        return b

    monkeypatch.setattr(dataset, "collate", half)
    rc, line = _run(data_root, "tiny-xib-eval")
    assert not line["correct"] and line["failed"] > 0


def test_control_runs_at_tiny_size(data_root):
    """The calibration's two readings in one process: the control is the
    cell's own lower-precision path, on the same weights and clips."""
    from portbench import calibrate

    ctx = _ctx(data_root, "tiny-xib-eval")
    r = calibrate.readings(ctx, [SEED, SEED + 1], [SEED, SEED + 1])
    assert len(r["sound"]) == len(r["control"]) == 2
    assert all(row["text_mismatch"] == 0 for row in r["sound"] + r["control"])
    assert max(x["gap"] for x in r["sound"]) <= ctx.cell["limits"]["logit_gap"]
    assert all(x["mean_gap"] >= 0 for x in r["sound"] + r["control"])


@pytest.mark.card
@pytest.mark.parametrize("cell", ["xib-qwen2-eval", "vl21av-eval"])
def test_control_fails_at_the_cells_size(card, cell):
    """On the card, at the cell's own size: three seeds of the control each
    read above one of the cell's limits, and a sound run below all."""
    from portbench import calibrate

    ctx = harness.context(harness.PACKAGE, cell, 11, False, card, time.perf_counter(),
                          str(harness.PACKAGE.parent / "build" / "portbench"))
    r = calibrate.readings(ctx, [5001], [5002, 5003, 5004])
    key = {"logit_gap": "gap", "logit_rel_err": "rel_err"}
    limits = {key[name]: limit for name, limit in ctx.cell["limits"].items()}
    assert all(r["sound"][0][k] <= limit for k, limit in limits.items())
    assert all(any(row[k] > limit for k, limit in limits.items()) for row in r["control"])
