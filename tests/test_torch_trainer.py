"""The port's trainer (``train/trainer.py``) and finetune CLI.

The whole slice against JAX: the JAX package's ``Trainer`` and the
port's, from the same parameters, on ``tests/test_trainer.py``'s tiny
run (4 train and 2 val clips, batch 2, 2 accumulation steps, 2 epochs,
augmentation on) in f32 with LoRA dropout off.  Every micro-step's loss
agrees within rel 2e-6 (the data, crops and updates are the same) and
the val metrics are equal.  The trained leaves agree within 1e-4 of the
largest |leaf| after the first update; after the second, within 1% of
one step of the peak lr: Adam divides each gradient by its running
root-mean-square, so an element whose two gradients nearly cancel moves
by the f32 rounding of the sum of the gradient's terms, on the order of
1e-3 of a step.

In the port alone: resuming from ``checkpoint_0`` and from a mid-epoch
``checkpoint_preempt`` gives the uninterrupted run's leaves and optimizer
state bit for bit; the nan guard counts consecutive non-finite losses and
aborts; the CLI runs end to end on the CPU and refuses what it does not
port, naming the ROADMAP.md item."""

import json

import numpy as np
import pytest

import torch

from mraudio_tpu.config import RunConfig as JRunConfig
from mraudio_tpu.config import TrainConfig as JTrainConfig
from mraudio_tpu.config import tiny_data_config as j_tiny_data
from mraudio_tpu.config import tiny_model_config as j_tiny
from mraudio_tpu.models.xinstructblip import XInstructBLIP as JModel
from mraudio_tpu.train.checkpoint import load_checkpoint as j_load_checkpoint
from mraudio_tpu.train.trainer import Trainer as JTrainer
from mraudio_tpu_torch.cli import finetune
from mraudio_tpu_torch.config import RunConfig, TrainConfig, tiny_data_config, tiny_model_config
from mraudio_tpu_torch.train import trainer as trainer_mod
from mraudio_tpu_torch.train.checkpoint import load_checkpoint
from test_torch_train_loss import f32_cfg, jax_tree, port_model

torch.set_num_threads(1)

LR = 3e-4


def _write_ann(path, n, start=0):
    path.write_text("".join(json.dumps({
        "vid": f"v{i}", "qid": i, "query": f"action {i}", "duration": 150,
        "relevant_windows": [[5 * i % 100, 5 * i % 100 + 10]]}) + "\n"
        for i in range(start, start + n)))
    return str(path)


@pytest.fixture(scope="module")
def anns(tmp_path_factory):
    root = tmp_path_factory.mktemp("ann")
    return _write_ann(root / "train.jsonl", 4), _write_ann(root / "val.jsonl", 2, 4)


def configs(anns, out, **train):
    """(JAX, port) RunConfigs of the tiny run, writing to ``out``."""
    pair = []
    for run_cfg, train_cfg, tiny, data in ((JRunConfig, JTrainConfig, j_tiny, j_tiny_data),
                                           (RunConfig, TrainConfig, tiny_model_config,
                                            tiny_data_config)):
        kw = dict(max_epoch=2, batch_size=2, warmup_steps=2, accum_grad_iters=2, lr=LR,
                  output_dir=str(out), val_freq=1, save_freq=1, num_workers=1)
        kw.update(train)
        pair.append(run_cfg(model=f32_cfg(tiny()), train=train_cfg(**kw),
                            data=data(n_frms=4).replace(train_annotation_file=anns[0],
                                                        val_annotation_file=anns[1])))
    return pair


def fresh_model(cfg):
    return port_model(cfg.model, cfg.data.audio)


def _events(out, kind):
    return [e for e in map(json.loads, open(f"{out}/train.jsonl")) if e["event"] == kind]


def _state(trainer):
    out = {f"leaf/{k}": p.detach().clone() for k, p in trainer.trainable.items()}
    out.update(trainer.opt.state_dict())
    return out


@pytest.fixture(scope="module")
def port_run(anns, tmp_path_factory):
    out = tmp_path_factory.mktemp("port")
    _, cfg = configs(anns, out)
    trainer = trainer_mod.Trainer(cfg, model=fresh_model(cfg), device="cpu")
    summary = trainer.train()
    return cfg, trainer, summary, out


@pytest.fixture(scope="module")
def jax_run(anns, port_run, tmp_path_factory):
    out = tmp_path_factory.mktemp("jax")
    jcfg, _ = configs(anns, out)
    params = jax_tree(fresh_model(port_run[0]))
    trainer = JTrainer(jcfg, model=JModel(jcfg.model, audio_cfg=jcfg.data.audio), params=params)
    summary = trainer.train()
    first = j_load_checkpoint(str(out / "checkpoint_0"))["model"]
    return ({"/".join(k): np.asarray(v) for k, v in trainer.trainable.items()},
            {"/".join(k): np.asarray(v) for k, v in first.items()}, summary, out)


def test_whole_slice_matches_jax(port_run, jax_run):
    _, trainer, summary, out = port_run
    j_final, j_first, j_summary, j_out = jax_run
    losses = [e["loss"] for e in _events(out, "train_step")]
    j_losses = [e["loss"] for e in _events(j_out, "train_step")]
    assert len(losses) == len(j_losses) == 4
    np.testing.assert_allclose(losses, j_losses, rtol=2e-6)
    assert [e["lr"] for e in _events(out, "train_step")] == \
        [e["lr"] for e in _events(j_out, "train_step")]
    strip = [{k: v for k, v in e.items() if k != "t"} for e in _events(out, "val")]
    assert strip == [{k: v for k, v in e.items() if k != "t"} for e in _events(j_out, "val")]
    assert summary == j_summary
    first = load_checkpoint(str(out / "checkpoint_0"))["model"]
    assert sorted(first) == sorted(j_first) == sorted(trainer.trainable)
    for k, j in j_first.items():
        assert np.abs(first[k].numpy() - j).max() <= 1e-4 * np.abs(j).max(), k
    for k, p in trainer.trainable.items():
        assert np.abs(p.detach().numpy() - j_final[k]).max() <= 1e-2 * LR, k
    moved = sum(not np.array_equal(p.detach().numpy(), j_first[k]) for k, p in
                trainer.trainable.items())
    assert moved > 0


def test_resume_from_epoch_checkpoint_is_bitwise(anns, port_run, tmp_path):
    cfg, straight, _, out = port_run
    _, cfg = configs(anns, tmp_path, resume_ckpt_path=str(out / "checkpoint_0.meta.json"))
    trainer = trainer_mod.Trainer(cfg, model=fresh_model(cfg), device="cpu")
    assert (trainer.start_epoch, trainer.global_step) == (1, 2)
    trainer.train()
    want, got = _state(straight), _state(trainer)
    assert sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want)


def test_resume_from_preempt_is_bitwise(anns, port_run, tmp_path):
    _, straight, _, _ = port_run
    _, cfg = configs(anns, tmp_path / "a")
    first = trainer_mod.Trainer(cfg, model=fresh_model(cfg), device="cpu")
    real = first.train_step

    def preempt_after_three(batch):
        loss = real(batch)
        first._preempt_requested = first.global_step + 1 == 3
        return loss

    first.train_step = preempt_after_three
    summary = first.train()
    assert summary["preempted"]
    meta = json.load(open(summary["preempt_ckpt"] + ".meta.json"))
    assert meta == {"epoch": 1, "global_step": 3, "step_in_epoch": 1}
    _, cfg = configs(anns, tmp_path / "b", resume_ckpt_path=summary["preempt_ckpt"])
    second = trainer_mod.Trainer(cfg, model=fresh_model(cfg), device="cpu")
    assert (second.start_epoch, second.global_step, second._skip_steps) == (1, 3, 1)
    second.train()
    want, got = _state(straight), _state(second)
    assert sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want)


def test_nan_guard_counts_and_aborts(anns, tmp_path):
    _, cfg = configs(anns, tmp_path, max_epoch=1, max_nan_skips=2)
    model = fresh_model(cfg)
    trainer = trainer_mod.Trainer(cfg, model=model, device="cpu")
    before = _state(trainer)
    real = model._loss_from_tokens
    model._loss_from_tokens = lambda *a, **k: real(*a, **k) * float("nan")
    with pytest.raises(RuntimeError, match="2 consecutive non-finite losses"):
        trainer.train()
    after = _state(trainer)
    assert all(torch.equal(before[k], after[k]) for k in before
               if k.startswith(("leaf/", "mu/", "nu/")))
    assert [e["consecutive"] for e in _events(tmp_path, "nan_skip")] == [1, 2]


def test_finetune_cli_on_the_cpu(anns, tmp_path):
    args = ["--model-size", "tiny", "--train-annotation-file", anns[0],
            "--val-annotation-file", anns[1], "--output-dir", str(tmp_path), "--max-epoch", "1",
            "--batch-size", "2", "--video-source", "synthetic", "--num-workers", "1"]
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        finetune.main(args)
    summary = finetune.main(args + ["--device", "cpu"])
    assert summary["best_epoch"] == 0 and 0 in summary["results"]
    for name in ("checkpoint_0", "checkpoint_0.meta.json", "train.jsonl"):
        assert (tmp_path / name).exists()
    assert len(_events(tmp_path, "train_step")) == 2


@pytest.mark.parametrize("flag,item", [
    (["--single-chip"], "A.2 and A.11"), (["--seq-shard"], "A.7"), (["--distributed"], "A.7"),
    (["--quant-frozen", "int8"], "A.2"), (["--model", "VideoLLaMA"], "A.6"),
])
def test_unported_flags_raise(anns, tmp_path, flag, item):
    """Flags whose machinery is not ported raise, naming their ROADMAP.md
    item; ``--model VideoLLaMA`` (A.6, ported) trains the tiny model: one
    epoch, its LoRA, connector and audio projector leaves in the
    checkpoint."""
    args = ["--model-size", "tiny", "--train-annotation-file", anns[0],
            "--val-annotation-file", anns[1], "--output-dir", str(tmp_path), "--device", "cpu",
            "--max-epoch", "1", "--batch-size", "2", "--video-source", "synthetic",
            "--num-workers", "1", *flag]
    if flag == ["--model", "VideoLLaMA"]:
        summary = finetune.main(args)
        assert summary["best_epoch"] == 0 and 0 in summary["results"]
        trained = load_checkpoint(str(tmp_path / "checkpoint_0"))["model"]
        assert {k.split("/")[0] for k in trained} == {"llm", "connector", "audio_proj"}
        assert len(_events(tmp_path, "train_step")) == 2
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        finetune.main(args)


@pytest.mark.parametrize("change,item", [
    (dict(train=dict(encoder_window=4)), "A.11"), (dict(train=dict(upload_overlap=True)), "A.11"),
    (dict(mesh=dict(data=2)), "A.7"),
])
def test_unported_config_raises(anns, tmp_path, change, item):
    _, cfg = configs(anns, tmp_path)
    if "train" in change:
        cfg = cfg.replace(train=cfg.train.replace(**change["train"]))
    else:
        cfg = cfg.replace(mesh=cfg.mesh.replace(**change["mesh"]))
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        trainer_mod.Trainer(cfg, model=fresh_model(cfg), device="cpu")


def test_best_checkpoint_follows_the_val_metric(anns, tmp_path):
    """``checkpoint_best`` is written when an epoch's MR-full-R1-avg beats
    the best so far (random weights score 0, so the val metric is set
    here), with its sidecar."""
    _, cfg = configs(anns, tmp_path)
    trainer = trainer_mod.Trainer(cfg, model=fresh_model(cfg), device="cpu")
    scores = iter([5.0, 2.0])
    trainer.eval_epoch = lambda: {"brief": {"MR-full-R1-avg": next(scores)}}
    summary = trainer.train()
    assert (summary["best_epoch"], summary["best_metric"]) == (0, 5.0)
    meta = json.load(open(tmp_path / "checkpoint_best.meta.json"))
    assert meta == {"epoch": 0, "global_step": 2, "step_in_epoch": 0}
    best = load_checkpoint(str(tmp_path / "checkpoint_best"))
    assert best["epoch"] == 0 and sorted(best["model"]) == sorted(trainer.trainable)


def test_eval_epoch_scores_saliency(anns, tmp_path):
    """With the saliency head, validation carries each clip's predicted
    scores on the 2 s grid beside its annotated ones, and the scorer
    reports the highlight metrics."""
    val = tmp_path / "val.jsonl"
    val.write_text("".join(json.dumps({
        "vid": f"v{i}", "qid": i, "query": f"action {i}", "duration": 150,
        "relevant_windows": [[10, 30]], "relevant_clip_ids": list(range(5, 15)),
        "saliency_scores": [[i % 5, 2, 4]] * 10}) + "\n" for i in range(2)))
    _, cfg = configs((anns[0], str(val)), tmp_path)
    cfg = cfg.replace(model=cfg.model.replace(saliency_head=True))
    trainer = trainer_mod.Trainer(cfg, model=fresh_model(cfg), device="cpu")
    assert "saliency_head/fc1/kernel" in trainer.trainable
    metrics = trainer.eval_epoch()
    assert any(k.startswith("HL-") for k in metrics["brief"])
