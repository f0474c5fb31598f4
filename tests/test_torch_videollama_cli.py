"""``--model VideoLLaMA`` through the port's CLIs against the JAX
package's, at the tiny size on the CPU, in f32 (LoRA dropout off).

* The factory builds VideoLLaMA with JAX's derived config.
* The evaluate CLI, from one merged checkpoint that both packages load
  (``--config`` naming it as ``llm_weights``): records equal and the JSONL
  byte-identical to what the JAX CLI runs for that config; ``generate_submit`` then
  ``generate_finalize`` gives ``generate``'s strings.
* The finetune CLI against the JAX ``Trainer`` from the same weights
  (the port's seeded init carried into JAX's tree): the same trainable
  leaves (LoRA, the connector, the audio projector), every micro-step's
  loss within rel 2e-6 over two epochs of two updates each, equal val
  metrics; its checkpoint loads through the evaluate CLI's
  ``--checkpoint``.
* The serve CLI refuses VideoLLaMA, naming ROADMAP.md C.3, as the JAX
  package's serve CLI cannot serve it either."""

import json

import numpy as np
import pytest

import jax
import torch

from mraudio_tpu.config import RunConfig as JRunConfig
from mraudio_tpu.config import TrainConfig as JTrainConfig
from mraudio_tpu.config import tiny_data_config as j_tiny_data
from mraudio_tpu.config import tiny_model_config as j_tiny
from mraudio_tpu.infer.evaluate import run_inference as j_run_inference
from mraudio_tpu.models import videollama as jvl
from mraudio_tpu.models.convert_weights import load_pretrained_params as j_load_pretrained_params
from mraudio_tpu.models.factory import build_model as j_build_model
from mraudio_tpu.train.trainer import Trainer as JTrainer
from mraudio_tpu_torch.cli import evaluate as cli_evaluate
from mraudio_tpu_torch.cli import finetune, serve
from mraudio_tpu_torch.config import RunConfig, TrainConfig, tiny_data_config, tiny_model_config
from mraudio_tpu_torch.models import videollama as tvl
from mraudio_tpu_torch.models.convert_weights import load_pretrained_params
from mraudio_tpu_torch.models.factory import build_model, canonical_model_name
from mraudio_tpu_torch.models.xinstructblip import XInstructBLIP
from mraudio_tpu_torch.train.checkpoint import load_checkpoint
from test_torch_convert_weights import _fill
from test_torch_train_loss import jax_tree
from test_torch_videollama_weights import _ckpt
from test_torch_videollama import jax_dict

torch.set_num_threads(1)

LR = 3e-4


def _f32(m):
    return m.replace(llm=m.llm.replace(dtype="float32"), vit=m.vit.replace(dtype="float32"),
                     beats=m.beats.replace(dtype="float32"),
                     lora=m.lora.replace(dropout=0.0))


def _write_ann(path, n, start=0):
    path.write_text("".join(json.dumps({
        "vid": f"v{i}", "qid": i, "query": f"a person does action {i}", "duration": 150 - 7 * i,
        "relevant_windows": [[5 * i % 100, 5 * i % 100 + 10]]}) + "\n"
        for i in range(start, start + n)))
    return str(path)


def test_factory_dispatch():
    for name in ("VideoLLaMA", "videollama2", "VideoLLaMA2-AV"):
        assert canonical_model_name(name) == "VideoLLaMA"
    with pytest.raises(ValueError, match="unknown model"):
        canonical_model_name("gpt5")
    cfg = RunConfig(model=tiny_model_config(), data=tiny_data_config(n_frms=4))
    assert isinstance(build_model(cfg, "cpu"), XInstructBLIP)
    model = build_model(cfg.replace(model_name="VideoLLaMA"), "cpu")
    assert isinstance(model, tvl.VideoLLaMA)
    jcfg = JRunConfig(model_name="VideoLLaMA", model=j_tiny(), data=j_tiny_data(n_frms=4))
    assert jax_dict(model.cfg) == j_build_model(jcfg).cfg.to_dict()


@pytest.fixture(scope="module")
def merged(tmp_path_factory):
    root = tmp_path_factory.mktemp("vl_cli")
    path = root / "videollama2_av.pth"
    torch.save({k: torch.from_numpy(v) for k, v in _ckpt("clip").items()}, str(path))
    return root, str(path)


def test_evaluate_cli_matches_jax(merged, monkeypatch):
    """The port's CLI from a YAML config naming the merged checkpoint, and
    what the JAX CLI runs for the same config (its factory, loader and
    ``run_inference``; its argparse path cannot take a YAML config for
    this backbone: the YAML's LoRA target list makes its flax modules
    unhashable under jit).  JAX's init, which the checkpoint covers but
    for the LoRA adapters, is a zero fill, and the port's LoRA B is zero:
    the adapters add nothing on either side."""
    root, ckpt = merged
    anns = [json.loads(line) for line in
            open(_write_ann(root / "ann.jsonl", 5)).read().splitlines()]
    jcfg = JRunConfig(model_name="VideoLLaMA", model=_f32(j_tiny()), llm_weights=ckpt,
                      data=j_tiny_data(n_frms=4))
    real = jvl.VideoLLaMA.init_params
    monkeypatch.setattr(jvl.VideoLLaMA, "init_params", lambda self, rng, jit=None: _fill(
        jax.eval_shape(lambda: real(self, rng, False)), 0.0))
    jm = j_build_model(jcfg)
    j_run_inference(jcfg, model=jm, params=j_load_pretrained_params(jm, jcfg), annotations=anns,
                    output_file=str(root / "j.jsonl"), batch_size=2, num_workers=1)

    yaml = root / "t.yaml"
    RunConfig(model=_f32(tiny_model_config()), data=tiny_data_config(n_frms=4),
              llm_weights=ckpt).to_yaml(str(yaml))
    result = cli_evaluate.main(["--model", "VideoLLaMA", "--config", str(yaml), "--annotation-file",
                                str(root / "ann.jsonl"), "--video-source", "synthetic",
                                "--batch-size", "2", "--num-workers", "1", "--device", "cpu",
                                "--output-file", str(root / "t.jsonl")])
    j_records = [json.loads(line) for line in (root / "j.jsonl").read_text().splitlines()]
    assert result["records"] == j_records and len(j_records) == 5
    assert (root / "t.jsonl").read_bytes() == (root / "j.jsonl").read_bytes()
    # 4 frames of a 2x2 patch grid pooled 2x2 and 4x: 1 video token, 4 audio, 48 prompt
    assert [b["prefix_len"] for b in result["batches"]] == [1 + 4 + 48] * 3


def test_submit_then_finalize_gives_generate():
    from mraudio_tpu_torch.data.dataset import MRDataset, collate

    cfg = RunConfig(model_name="VideoLLaMA", model=tiny_model_config(),
                    data=tiny_data_config(n_frms=4))
    model = load_pretrained_params(build_model(cfg, "cpu"), cfg)
    ds = MRDataset(cfg.data, annotations=[{"vid": f"v{i}", "qid": i, "query": f"q {i}",
                                           "duration": 100, "relevant_windows": [[1, 9]]}
                                          for i in range(2)])
    batch = collate([ds.get(i) for i in range(2)], 2)
    direct = model.generate(batch=batch)
    assert len(direct) == 2
    assert model.generate_finalize(model.generate_submit(batch=batch)) == direct
    assert model.generate_finalize(model.generate_submit(batch=batch),
                                   return_saliency=True) == (direct, None)


@pytest.fixture(scope="module")
def finetune_runs(tmp_path_factory):
    """(port output dir, port config, JAX trainer, JAX output dir): the
    finetune CLI and the JAX ``Trainer`` on 4 train and 2 val clips,
    batch 2, 2 accumulation steps, 2 epochs, from the same weights."""
    root = tmp_path_factory.mktemp("vl_ft")
    train_ann, val_ann = _write_ann(root / "train.jsonl", 4), _write_ann(root / "val.jsonl", 2, 4)
    kw = dict(max_epoch=2, batch_size=2, warmup_steps=2, accum_grad_iters=2, lr=LR,
              val_freq=1, save_freq=1, num_workers=1)
    tcfg = RunConfig(model_name="VideoLLaMA", model=_f32(tiny_model_config()),
                     train=TrainConfig(output_dir=str(root / "port"), **kw),
                     data=tiny_data_config(n_frms=4).replace(train_annotation_file=train_ann,
                                                             val_annotation_file=val_ann))
    config = root / "run.json"
    config.write_text(json.dumps(tcfg.to_dict()))
    finetune.main(["--model", "VideoLLaMA", "--config", str(config), "--device", "cpu",
                   "--train-annotation-file", train_ann, "--val-annotation-file", val_ann,
                   "--output-dir", str(root / "port"), "--max-epoch", "2", "--batch-size", "2",
                   "--num-workers", "1", "--video-source", "synthetic"])
    # the weights the CLI started from: the same seeded init, built again
    tree = jax_tree(load_pretrained_params(build_model(tcfg, "cpu"), tcfg))
    jcfg = JRunConfig(model_name="VideoLLaMA", model=_f32(j_tiny()),
                      train=JTrainConfig(output_dir=str(root / "jax"), **kw),
                      data=j_tiny_data(n_frms=4).replace(train_annotation_file=train_ann,
                                                         val_annotation_file=val_ann))
    jm = j_build_model(jcfg)
    trainer = JTrainer(jcfg, model=jm, params=tree)
    trainer.train()
    return root / "port", tcfg, trainer, root / "jax"


def _events(out, kind):
    return [e for e in map(json.loads, open(f"{out}/train.jsonl")) if e["event"] == kind]


def test_finetune_cli_matches_the_jax_trainer(finetune_runs):
    out, _, j_trainer, j_out = finetune_runs
    trained = load_checkpoint(str(out / "checkpoint_1"))["model"]
    assert sorted(trained) == sorted("/".join(k) for k in j_trainer.trainable)
    assert any(k.startswith("connector/") for k in trained)
    assert any(k.startswith("audio_proj/") for k in trained)
    assert not any(k.startswith(("vit/", "beats/")) for k in trained)
    losses = [e["loss"] for e in _events(out, "train_step")]
    j_losses = [e["loss"] for e in _events(j_out, "train_step")]
    assert len(losses) == len(j_losses) == 4
    np.testing.assert_allclose(losses, j_losses, rtol=2e-6)
    strip = [{k: v for k, v in e.items() if k != "t"} for e in _events(out, "val")]
    assert strip == [{k: v for k, v in e.items() if k != "t"} for e in _events(j_out, "val")]


def test_finetune_checkpoint_loads_through_evaluate(finetune_runs, tmp_path, monkeypatch):
    import mraudio_tpu_torch.infer.evaluate as infer_evaluate

    out, tcfg, _, _ = finetune_runs
    config = tmp_path / "run.json"
    config.write_text(json.dumps(tcfg.to_dict()))
    seen = {}
    real = infer_evaluate.run_inference

    def capture(cfg, model=None, **kw):
        seen["model"] = model
        return real(cfg, model=model, **kw)

    monkeypatch.setattr(infer_evaluate, "run_inference", capture)
    result = cli_evaluate.main(["--model", "VideoLLaMA", "--config", str(config),
                                "--annotation-file", _write_ann(tmp_path / "a.jsonl", 2),
                                "--output-file", str(tmp_path / "p.jsonl"), "--device", "cpu",
                                "--video-source", "synthetic", "--num-workers", "1",
                                "--checkpoint", str(out / "checkpoint_1")])
    assert len(result["records"]) == 2
    trained = load_checkpoint(str(out / "checkpoint_1"))["model"]
    got = seen["model"].connector.proj_in.kernel
    assert torch.equal(got, trained["connector/proj_in/kernel"].to(got.dtype))


def test_serve_cli_refuses_videollama_naming_c3(tmp_path):
    ann = _write_ann(tmp_path / "ann.jsonl", 1)
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md C\.3") as err:
        serve.main(["--model", "VideoLLaMA", "--annotation-file", ann, "--model-size", "tiny",
                    "--video-source", "synthetic", "--device", "cpu"])
    assert "A.6" not in str(err.value) and "prepare_text" in str(err.value)
