"""The port's evaluate path end to end against the JAX package:
``run_inference`` records and JSONL, ``--num-chunks`` sharding, the OOM
batch fallback, the CLIs (evaluate, merge_chunks, mr_eval) and the
golden pipeline outputs.

Same records as JAX: the tiny configuration in f32 with int8 weights
and an int8 KV cache, a segmented prefill (``prefill_chunk=16``, the
prefix is 182 tokens), chunked attention and the XLA-route projections,
weights carried across with ``load_jax_params_``; the records must be
equal and the JSONL files byte-identical."""

import json

import numpy as np
import pytest

import jax
import torch

from mraudio_tpu.config import RunConfig as JRunConfig
from mraudio_tpu.config import tiny_data_config as j_tiny_data
from mraudio_tpu.config import tiny_model_config as j_tiny
from mraudio_tpu.data.dataset import MRDataset as JDataset
from mraudio_tpu.data.dataset import collate as j_collate
from mraudio_tpu.eval.mr_eval import eval_main as j_eval_main
from mraudio_tpu.eval.mr_eval import eval_submission as j_eval_submission
from mraudio_tpu.infer.evaluate import run_inference as j_run_inference
from mraudio_tpu.models.xinstructblip import XInstructBLIP as JModel
from mraudio_tpu_torch.cli import evaluate as cli_evaluate
from mraudio_tpu_torch.cli import merge_chunks
from mraudio_tpu_torch.config import RunConfig, tiny_data_config, tiny_model_config
from mraudio_tpu_torch.data.dataset import MRDataset, collate
from mraudio_tpu_torch.eval.mr_eval import eval_main, eval_submission
from mraudio_tpu_torch.infer.evaluate import run_inference
from mraudio_tpu_torch.models.convert_jax import load_jax_params_
from mraudio_tpu_torch.models.xinstructblip import XInstructBLIP

torch.set_num_threads(1)

PREFILL_CHUNK = 16


def _annotations(n=5):
    return [
        {"vid": f"v{i}", "qid": i, "query": f"a person does action {i}",
         "duration": 150 - 7 * i, "relevant_windows": [[10 + i, 30 + i]]}
        for i in range(n)
    ]


def _f32_int8(cfg):
    llm = cfg.llm.replace(dtype="float32", quantization="int8", kv_quant="int8",
                          prefill_chunk=PREFILL_CHUNK)
    return cfg.replace(llm=llm, vit=cfg.vit.replace(dtype="float32"),
                       beats=cfg.beats.replace(dtype="float32"),
                       qformer=cfg.qformer.replace(dtype="float32"))


def _refill_int8(tree, rng):
    """The flax init leaves int8 weights at 0; give them values."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _refill_int8(v, rng)
            if "w_int8" in v:
                out[k]["w_int8"] = rng.integers(-127, 128, v["w_int8"].shape).astype(np.int8)
                out[k]["scale"] = (rng.uniform(0.5, 1.5, v["w_int8"].shape[1])
                                   * (0.05 / 73.6)).astype(np.float32)
        elif k == "lora_b":
            out[k] = (rng.standard_normal(v.shape) * 0.05).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def pair():
    """(JAX cfg, model, params), (port cfg, model) with the same weights;
    the port's model is already cast for inference by its first run."""
    jcfg = JRunConfig(model=_f32_int8(j_tiny()), data=j_tiny_data(n_frms=4))
    jm = JModel(jcfg.model, audio_cfg=jcfg.data.audio)
    params = _refill_int8(jax.device_get(jm.init_params(jax.random.PRNGKey(0))),
                          np.random.default_rng(1))
    tcfg = RunConfig(model=_f32_int8(tiny_model_config()), data=tiny_data_config(n_frms=4))
    tm = XInstructBLIP(tcfg.model, audio_cfg=tcfg.data.audio, device="cpu")
    load_jax_params_(tm, params)
    return (jcfg, jm, params), (tcfg, tm)


@pytest.fixture(scope="module")
def port_run(pair, tmp_path_factory):
    _, (tcfg, tm) = pair
    path = tmp_path_factory.mktemp("port") / "preds.jsonl"
    result = run_inference(tcfg, model=tm, annotations=_annotations(), output_file=str(path),
                           batch_size=2, num_workers=1, device="cpu")
    return result, path


def test_records_and_jsonl_match_jax(pair, port_run, tmp_path):
    (jcfg, jm, params), _ = pair
    result, path = port_run
    jpath = tmp_path / "jax.jsonl"
    ref = j_run_inference(jcfg, model=jm, params=params, annotations=_annotations(),
                          output_file=str(jpath), batch_size=2, num_workers=1)
    assert result["records"] == ref["records"]
    assert path.read_bytes() == jpath.read_bytes()
    assert result["batch_size"] == 2 and result["clips_per_sec"] > 0
    # 182-token prefix in 16-token segments; 3 batches, the last padded
    assert [b["prefill_segments"] for b in result["batches"]] == [12, 12, 12]
    assert [b["prefix_len"] for b in result["batches"]] == [182, 182, 182]
    assert result["stages"]["generate"]["items"] == 5


def test_chunk_union_equals_full_run(pair, port_run, tmp_path):
    _, (tcfg, tm) = pair
    full, _ = port_run
    paths = []
    for idx in range(2):
        cfg = tcfg.replace(data=tcfg.data.replace(num_chunks=2, chunk_idx=idx))
        paths.append(str(tmp_path / f"chunk{idx}.jsonl"))
        run_inference(cfg, model=tm, annotations=_annotations(), output_file=paths[-1],
                      batch_size=2, num_workers=1, device="cpu")
    assert merge_chunks.merge(paths) == full["records"]
    merged = tmp_path / "merged.jsonl"
    merge_chunks.main(["--output", str(merged)] + paths)
    assert [json.loads(line) for line in merged.read_text().splitlines()] == full["records"]


class _OOMAbove:
    """The port's model, raising ``torch.cuda.OutOfMemoryError`` from
    ``generate_submit`` whenever the batch is wider than ``max_rows``."""

    def __init__(self, inner, max_rows, error=None):
        self._inner = inner
        self._max_rows = max_rows
        self._error = error or torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        self.n_oom = 0
        self.cfg = inner.cfg
        self.llm_tokenizer = inner.llm_tokenizer
        self.device = inner.device

    def named_parameters(self):
        return self._inner.named_parameters()

    def device_inputs(self, batch):
        return self._inner.device_inputs(batch)

    def generate_submit(self, batch=None, **kw):
        if len(batch.qid) > self._max_rows:
            self.n_oom += 1
            raise self._error
        return self._inner.generate_submit(batch=batch, **kw)

    def generate_finalize(self, pending):
        return self._inner.generate_finalize(pending)


def test_batch_fallback_halves_batch_and_matches_clean_run(pair, port_run):
    _, (tcfg, tm) = pair
    clean = run_inference(tcfg, model=tm, annotations=_annotations(), batch_size=1,
                          num_workers=1, device="cpu")
    wrapped = _OOMAbove(tm, max_rows=1)
    result = run_inference(tcfg, model=wrapped, annotations=_annotations(), batch_size=4,
                           num_workers=1, device="cpu")
    assert wrapped.n_oom == 2            # 4 -> 2 -> 1
    assert result["batch_size"] == 1
    assert result["records"] == clean["records"] == port_run[0]["records"]


@pytest.mark.parametrize("case", ["fallback_disabled", "not_oom"])
def test_errors_that_propagate(pair, case):
    _, (tcfg, tm) = pair
    if case == "fallback_disabled":
        wrapped, kw, err = _OOMAbove(tm, 1), {"batch_fallback": False}, torch.cuda.OutOfMemoryError
    else:
        wrapped, kw, err = _OOMAbove(tm, 1, ValueError("unrelated bug")), {}, ValueError
    with pytest.raises(err):
        run_inference(tcfg, model=wrapped, annotations=_annotations(3), batch_size=2,
                      num_workers=1, device="cpu", **kw)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    gt = d / "gt.jsonl"
    gt.write_text("".join(json.dumps(a) + "\n" for a in _annotations()))
    out = d / "preds.jsonl"
    result = cli_evaluate.main(["--annotation-file", str(gt), "--output-file", str(out),
                                "--model-size", "tiny", "--video-source", "synthetic",
                                "--device", "cpu", "--num-workers", "1"])
    return d, gt, out, result


def test_cli_writes_submission(cli_run):
    _, _, out, result = cli_run
    records = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["qid"] for r in records] == list(range(5))
    assert records == result["records"]
    for r in records:
        assert set(r) == {"qid", "query", "vid", "pred_relevant_windows", "raw_out"}
        assert isinstance(r["pred_relevant_windows"], list)


def test_cli_scorer_matches_jax_scorer(cli_run):
    d, gt, out, _ = cli_run
    ours, theirs = d / "ours.json", d / "theirs.json"
    eval_main(["--submission_path", str(out), "--gt_path", str(gt),
               "--save_path", str(ours), "--not_verbose"])
    j_eval_main(["--submission_path", str(out), "--gt_path", str(gt),
                 "--save_path", str(theirs), "--not_verbose"])
    assert ours.read_text() == theirs.read_text()
    assert json.loads(ours.read_text())["brief"]["MR-full-invalid_pred_num"] == 5


def test_scorer_matches_jax_on_real_windows_and_saliency():
    rng = np.random.default_rng(7)
    gt, sub = [], []
    for qid in range(12):
        windows = [[float(s), float(s + rng.integers(4, 30))]
                   for s in sorted(rng.integers(0, 110, rng.integers(1, 4)))]
        clips = sorted(rng.choice(75, 10, replace=False).tolist())
        gt.append({"qid": qid, "duration": 150, "relevant_windows": windows,
                   "relevant_clip_ids": clips,
                   "saliency_scores": rng.integers(0, 5, (10, 3)).tolist()})
        preds = [[w[0] + float(rng.normal(0, 3)), w[1] + float(rng.normal(0, 3)),
                  float(rng.uniform())] for w in windows]
        preds.append([float(rng.uniform(0, 100)), 140.0, 0.1])
        sub.append({"qid": qid, "pred_relevant_windows": preds,
                    "pred_saliency_scores": rng.uniform(size=75).tolist()})
    ours = eval_submission(json.loads(json.dumps(sub)), json.loads(json.dumps(gt)))
    theirs = j_eval_submission(json.loads(json.dumps(sub)), json.loads(json.dumps(gt)))
    assert json.dumps(ours) == json.dumps(theirs)
    assert ours["brief"]["MR-full-mAP"] > 0 and "HL-min-VeryGood-Hit1" in ours["brief"]


@pytest.mark.parametrize("flag", ["--model-path=x", "--audio-encoder=x", "--params-store=x",
                                  "--checkpoint=x", "--quant-encoders",
                                  "--seq-shard", "--model=VideoLLaMA"])
def test_cli_unported_flags_raise(flag, tmp_path):
    gt = tmp_path / "gt.jsonl"
    gt.write_text("".join(json.dumps(a) + "\n" for a in _annotations(1)))
    with pytest.raises(NotImplementedError, match="ROADMAP.md A."):
        cli_evaluate.main(["--annotation-file", str(gt), "--output-file",
                           str(tmp_path / "p.jsonl"), "--model-size", "tiny",
                           "--video-source", "synthetic", "--device", "cpu", flag])


@pytest.mark.parametrize("field", ["llm_weights", "vit_weights", "beats_weights",
                                   "video_qformer_weights", "audio_qformer_weights",
                                   "blip2_stage1_weights", "tokenizer_path"])
def test_cli_config_naming_weights_raises(field, tmp_path):
    """A JAX package YAML that names converted weights is refused, not run
    with random weights."""
    config = tmp_path / "run.yaml"
    JRunConfig(model=j_tiny(), data=j_tiny_data(n_frms=4),
               **{field: str(tmp_path / "weights")}).to_yaml(str(config))
    gt = tmp_path / "gt.jsonl"
    gt.write_text("".join(json.dumps(a) + "\n" for a in _annotations(1)))
    with pytest.raises(NotImplementedError, match=f"{field}.*ROADMAP.md A.8"):
        cli_evaluate.main(["--annotation-file", str(gt), "--output-file",
                           str(tmp_path / "p.jsonl"), "--config", str(config),
                           "--video-source", "synthetic", "--device", "cpu"])
    assert not (tmp_path / "p.jsonl").exists()


def test_cli_without_device_flag_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    gt = tmp_path / "gt.jsonl"
    gt.write_text("".join(json.dumps(a) + "\n" for a in _annotations(1)))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_evaluate.main(["--annotation-file", str(gt), "--output-file",
                           str(tmp_path / "p.jsonl"), "--model-size", "tiny",
                           "--video-source", "synthetic"])
    assert not (tmp_path / "p.jsonl").exists()


GOLDEN_ANNOTATIONS = [
    {"vid": f"v{i}", "qid": i, "query": f"a person does action {i}",
     "duration": 150, "relevant_windows": [[10 + i, 30 + i]]}
    for i in range(3)
]


def test_golden_pipeline_outputs():
    """``tests/golden/tiny_pipeline.json``'s generate outputs: the golden
    test's config (bf16, no quantization, chunked attention), its
    annotations and JAX ``PRNGKey(0)`` weights, uncast."""
    import pathlib

    want = json.loads((pathlib.Path(__file__).parent / "golden" / "tiny_pipeline.json")
                      .read_text())["outputs"]
    jcfg = JRunConfig(model=j_tiny(), data=j_tiny_data(n_frms=4))
    params = jax.device_get(JModel(jcfg.model, audio_cfg=jcfg.data.audio)
                            .init_params(jax.random.PRNGKey(0)))
    cfg = RunConfig(model=tiny_model_config(), data=tiny_data_config(n_frms=4))
    model = load_jax_params_(XInstructBLIP(cfg.model, audio_cfg=cfg.data.audio,
                                           device="cpu"), params)
    ds = MRDataset(cfg.data, annotations=GOLDEN_ANNOTATIONS, split="eval")
    batch = collate([ds.get(i) for i in range(3)], 3)
    jds = JDataset(jcfg.data, annotations=GOLDEN_ANNOTATIONS, split="eval")
    jbatch = j_collate([jds.get(i) for i in range(3)], 3)
    np.testing.assert_array_equal(batch.video, jbatch.video)
    np.testing.assert_array_equal(batch.audio, jbatch.audio)
    assert model.generate(batch=batch) == want
