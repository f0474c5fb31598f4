"""The single-chip memory levers in the port: the packed upload
(``utils/packing.py``), the windowed trainer (``train.encoder_window``,
``train.upload_overlap``) and the ``--single-chip`` and
``--quant-encoders`` flags.

The packing round trip is bit for bit in every dtype.  As in the JAX
package (``tests/test_encoder_window.py``), a windowed epoch gives the
per-batch split step's losses and trained leaves bit for bit, with
gradient accumulation 1 and 2 and with the next window's upload staged;
between windows the encoders are on the host, and validation brings them
back for its generate.  ``--single-chip`` sets the JAX package's fields
(``mraudio_tpu/cli/finetune.py:141-160``)."""

import json

import pytest

import torch

from mraudio_tpu_torch.cli import evaluate as cli_evaluate
from mraudio_tpu_torch.cli import finetune
from mraudio_tpu_torch.train import trainer as trainer_mod
from mraudio_tpu_torch.utils.packing import make_packed_uploader, pack_tree, unpack_tree
from test_torch_trainer import _write_ann, configs, fresh_model

torch.set_num_threads(1)


def test_pack_round_trip_bit_for_bit():
    gen = torch.Generator().manual_seed(0)
    tree = {
        "a/kernel": torch.randn((7, 5), generator=gen).to(torch.bfloat16),
        "b/w_int8": torch.randint(-128, 128, (3, 33), generator=gen, dtype=torch.int8),
        "c/scale": torch.randn(13, generator=gen),
        "d/w_int4": torch.randint(0, 256, (2, 4, 6), generator=gen, dtype=torch.uint8),
        "e/nan": torch.tensor([float("nan"), -0.0, float("inf")]),
        "f/scalar": torch.tensor(3.5),
    }
    buffers, metas = pack_tree(tree)
    assert sorted(buffers) == ["bfloat16", "float32", "int8", "uint8"]
    for _, shape, dt, off in metas:
        assert off * buffers[dt].element_size() % 256 == 0        # leaves start aligned
    upload, nbytes = make_packed_uploader(tree, "cpu")
    assert nbytes == sum(b.numel() * b.element_size() for b in buffers.values())
    for views in (unpack_tree(buffers, metas), upload(), upload(upload.stage()), upload.host):
        assert sorted(views) == sorted(tree)
        for k, v in tree.items():
            assert views[k].dtype == v.dtype and views[k].shape == v.shape
            assert torch.equal(_bits(views[k]), _bits(v)), k


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


@pytest.fixture(scope="module")
def anns(tmp_path_factory):
    root = tmp_path_factory.mktemp("wann")
    return _write_ann(root / "train.jsonl", 4), _write_ann(root / "val.jsonl", 2, 4)


def _epoch(anns, out, **train):
    """One epoch of the tiny run at batch 1 (4 micro-steps); returns the
    trainer, its run-log losses and its window events."""
    _, cfg = configs(anns, out, batch_size=1, max_epoch=1, **train)
    trainer = trainer_mod.Trainer(cfg, model=fresh_model(cfg), device="cpu")
    trainer.train_epoch(0)
    events = [json.loads(line) for line in open(out / "train.jsonl")]
    return (trainer, [e["loss"] for e in events if e["event"] == "train_step"],
            [e for e in events if e["event"] == "window"])


@pytest.mark.parametrize("accum", [1, 2])
def test_encoder_window_matches_per_batch_split(anns, tmp_path, accum):
    base, base_losses, _ = _epoch(anns, tmp_path / "split", accum_grad_iters=accum)
    windowed, losses, windows = _epoch(anns, tmp_path / "window", accum_grad_iters=accum,
                                       encoder_window=2)
    assert len(losses) == 4 and losses == base_losses
    for k, p in base.trainable.items():
        assert torch.equal(windowed.trainable[k], p), k
    assert [w["batches"] for w in windows] == [2, 2]
    assert not any(w["encoders_on_device_during_steps"] or w["staged_upload"] for w in windows)
    assert not windowed.encoders_on_device()


def test_upload_overlap_bitwise_and_cleanup(anns, tmp_path):
    """The next window's copies staged during this window's loss steps:
    the serialized run's bits, and no staged copy left after the epoch;
    validation uploads the encoders and leaves them on the host."""
    serial, serial_losses, _ = _epoch(anns, tmp_path / "serial", encoder_window=2)
    staged, losses, windows = _epoch(anns, tmp_path / "staged", encoder_window=2,
                                     upload_overlap=True)
    assert losses == serial_losses
    for k, p in serial.trainable.items():
        assert torch.equal(staged.trainable[k], p), k
    assert [(w["staged_upload"], w["next_staged"]) for w in windows] == [(False, True),
                                                                        (True, False)]
    assert staged._staged_enc is None
    assert "brief" in staged.eval_epoch()
    assert not staged.encoders_on_device()


def test_encoder_window_requires_split(anns, tmp_path):
    _, cfg = configs(anns, tmp_path, encoder_window=2, split_encode_step=False)
    with pytest.raises(ValueError, match="split_encode_step"):
        trainer_mod.Trainer(cfg, model=fresh_model(cfg), device="cpu")


def test_single_chip_and_quant_encoders_parse_and_build(tmp_path, monkeypatch):
    """``--single-chip`` sets the JAX package's fields, the window at
    least 12 (a config's larger window kept); ``--quant-encoders`` sets
    ``RunConfig.quant_encoders``."""
    args = ["--train-annotation-file", "t", "--val-annotation-file", "v", "--output-dir",
            str(tmp_path), "--model-size", "tiny"]
    seen = {}

    class Stop(Exception):
        pass

    def stop(cfg):
        seen["cfg"] = cfg
        raise Stop

    monkeypatch.setattr(trainer_mod, "refuse_unported", stop)
    for extra, window in (([], 12), (["--config", str(tmp_path / "c.json")], 20)):
        (tmp_path / "c.json").write_text(json.dumps({"train": {"encoder_window": 20}}))
        with pytest.raises(Stop):
            finetune.main([*args, "--single-chip", *extra])
        cfg = seen["cfg"]
        llm, train = cfg.model.llm, cfg.train
        assert (llm.grad_checkpoint, llm.scan_layers, llm.attention_unroll_train) == (True,) * 3
        assert cfg.model.vit.grad_checkpoint
        assert (train.quant_frozen, train.split_encode_step, train.encoder_window) == \
            ("int8", True, window)
    monkeypatch.setattr("mraudio_tpu_torch.infer.evaluate.refuse_unported", stop)
    with pytest.raises(Stop):
        cli_evaluate.main(["--annotation-file", "a", "--output-file", "p", "--model-size",
                           "tiny", "--device", "cpu", "--quant-encoders"])
    assert seen["cfg"].quant_encoders
