"""The port's parity runner (``cli/parity.py``) and its evaluate path on
converted weights, against the JAX package.

``run_inference`` on the same fabricated tiny artifacts (f32, int8
weights, synthetic video) writes the same JSONL as JAX's, byte for byte.
The parity CLI with ``--fabricate`` runs without a reference
(NO-REFERENCE, a store saved), passes against the JAX parity CLI's
predictions on the same artifacts (in the tiny preset's bf16; the two
JSONL files are byte-identical too), reuses its store, and fails on a
perturbed reference.  JAX's random init is replaced by zeros
(``jax_init_filled``): the only leaves no artifact covers are LoRA's A
and B, and with B zero in both packages the delta vanishes, so both
compute the same function whatever A holds."""

import json
import os
import shutil

import pytest

import torch

import mraudio_tpu.models.convert_weights as jcw
from mraudio_tpu.cli import parity as j_parity
from mraudio_tpu.infer.evaluate import run_inference as j_run_inference
from mraudio_tpu.models.xinstructblip import XInstructBLIP as JModel
from mraudio_tpu_torch.cli import parity
from mraudio_tpu_torch.infer.evaluate import run_inference
from test_torch_convert_weights import WEIGHT_FIELDS, configs, jax_init_filled

torch.set_num_threads(1)

ANNOTATIONS = [{"vid": f"v{i}", "qid": i, "query": f"a person does thing {i}",
                "duration": 150 - 11 * i, "relevant_windows": [[10 * i, 10 * i + 20]]}
               for i in range(3)]


@pytest.fixture(scope="module")
def first_run(tmp_path_factory):
    """The port's fabricate + convert + evaluate pass, its store saved."""
    root = tmp_path_factory.mktemp("parity")
    ann = root / "ann.jsonl"
    ann.write_text("".join(json.dumps(a) + "\n" for a in ANNOTATIONS))
    out = str(root / "run1")
    report = parity.main(["--fabricate", "--model-size", "tiny", "--annotation", str(ann),
                          "--video-source", "synthetic", "--output-dir", out, "--save-store",
                          "--batch-size", "2", "--num-workers", "1", "--device", "cpu"])
    return root, str(ann), out, report


@pytest.fixture(scope="module")
def jax_run(first_run):
    """The JAX parity CLI on the port's fabricated artifacts."""
    root, ann, out1, _ = first_run
    out = str(root / "jax")
    with jax_init_filled(0.0):
        j_parity.main(["--ckpt-dir", os.path.join(out1, "fabricated"), "--model-size", "tiny",
                       "--annotation", ann, "--video-source", "synthetic", "--output-dir", out,
                       "--batch-size", "2", "--num-workers", "0"])
    return out


def _report(out):
    with open(os.path.join(out, "report.json")) as f:
        return json.load(f)


def _parity(first_run, name, *extra):
    root, ann, out1, _ = first_run
    out = str(root / name)
    parity.main(["--ckpt-dir", os.path.join(out1, "fabricated"), "--model-size", "tiny",
                 "--annotation", ann, "--video-source", "synthetic", "--output-dir", out,
                 "--batch-size", "2", "--num-workers", "1", "--device", "cpu", *extra])
    return out


def test_parity_no_reference(first_run):
    _, _, out, report = first_run
    assert report["pass"] is None and report["reference_brief"] is None
    assert report == _report(out)
    assert "MR-full-R1@0.5" in report["ours_brief"]
    assert sorted(report["artifacts"]) == sorted(parity.CONVENTIONAL)
    assert os.path.isfile(os.path.join(out, "params_store"))
    rows = [json.loads(line) for line in open(os.path.join(out, "predictions.jsonl"))]
    assert [r["qid"] for r in rows] == [0, 1, 2]


def test_parity_passes_against_jax_predictions(first_run, jax_run):
    out = _parity(first_run, "vs_jax", "--reference-jsonl",
                  os.path.join(jax_run, "predictions.jsonl"))
    report = _report(out)
    assert report["pass"] is True and report["brief_diff"]["max_abs_diff"] == 0
    assert report["span_diff"]["mismatched"] == 0 and report["span_diff"]["common_qids"] == 3
    assert report["ours_brief"] == _report(jax_run)["ours_brief"]
    assert open(os.path.join(out, "predictions.jsonl")).read() == \
        open(os.path.join(jax_run, "predictions.jsonl")).read()


def test_parity_reuses_its_store(first_run):
    """``--reuse-store`` loads the saved store (here with the Vicuna file
    gone, so that a conversion could not run) and predicts the same."""
    root, _, out1, _ = first_run
    os.makedirs(root / "reuse")
    for name in ("params_store", "params_store.meta.json"):
        shutil.copy(os.path.join(out1, name), root / "reuse" / name)
    out = _parity(first_run, "reuse", "--reuse-store", "--model-path", str(root / "gone.pth"))
    assert open(os.path.join(out, "predictions.jsonl")).read() == \
        open(os.path.join(out1, "predictions.jsonl")).read()


def test_parity_fails_on_perturbed_reference(first_run, tmp_path):
    _, _, out1, _ = first_run
    rows = [json.loads(line) for line in open(os.path.join(out1, "predictions.jsonl"))]
    rows[1]["pred_relevant_windows"] = [[1.0, 99.0]]
    bad = tmp_path / "bad.jsonl"
    bad.write_text("".join(json.dumps(r) + "\n" for r in rows))
    with pytest.raises(SystemExit) as err:
        _parity(first_run, "perturbed", "--reference-jsonl", str(bad))
    assert err.value.code == 1
    report = _report(os.path.join(os.path.dirname(out1), "perturbed"))
    assert report["pass"] is False and report["span_diff"]["mismatched"] == 1


def test_run_inference_on_converted_weights_matches_jax(first_run, tmp_path):
    """f32 with int8 weights, the six artifacts named by the config: the
    port's ``run_inference`` builds and loads its model itself; JAX's is
    given ``load_pretrained_params``' tree.  Records equal, JSONL
    byte-identical."""
    _, _, out1, _ = first_run
    ck = os.path.join(out1, "fabricated")
    paths = {WEIGHT_FIELDS[role]: os.path.join(ck, name)
             for role, (name, *_) in parity.CONVENTIONAL.items()}
    jcfg, tcfg = configs("int8", **paths)
    with jax_init_filled(0.0):
        jm = JModel(jcfg.model, audio_cfg=jcfg.data.audio)
        params = jcw.load_pretrained_params(jm, jcfg)
    ref = j_run_inference(jcfg, model=jm, params=params, annotations=ANNOTATIONS,
                          output_file=str(tmp_path / "jax.jsonl"), batch_size=2, num_workers=1)
    ours = run_inference(tcfg, annotations=ANNOTATIONS, output_file=str(tmp_path / "port.jsonl"),
                         batch_size=2, num_workers=1, device="cpu")
    assert ours["records"] == ref["records"]
    assert (tmp_path / "port.jsonl").read_bytes() == (tmp_path / "jax.jsonl").read_bytes()
