"""Trained checkpoints in the evaluate and serve CLIs, against the JAX
package's.

A trainable dict (LoRA and saliency-head leaves) is saved by JAX's
``save_checkpoint``, read back with JAX's ``load_checkpoint`` and written
in the port's format (``train/checkpoint.py``; the port reads no orbax
directory).  Both packages then run their evaluate CLI on the same base
weights (each package's param store of one tree) with ``--checkpoint``,
in f32 with the saliency head on: the JSONL lines are byte-identical
apart from the saliency scores, which agree within 1e-5 (the video tokens
they read carry the Q-Former projection's bf16 rounding, ROADMAP.md
C.3).  The serve CLIs' records are equal, latency
aside.  The port's ``load_checkpoint`` resolves a ``.meta.json`` path and
``apply_trainable`` refuses a leaf the model lacks."""

import json

import numpy as np
import pytest
import yaml

import torch

from mraudio_tpu.cli import evaluate as j_cli_evaluate
from mraudio_tpu.cli import serve as j_cli_serve
from mraudio_tpu.cli.convert import save_param_store as j_save_store
from mraudio_tpu.config import RunConfig as JRunConfig
from mraudio_tpu.config import tiny_data_config as j_tiny_data
from mraudio_tpu.config import tiny_model_config as j_tiny
from mraudio_tpu.train.checkpoint import load_checkpoint as j_load_checkpoint
from mraudio_tpu.train.checkpoint import save_checkpoint as j_save_checkpoint
from mraudio_tpu_torch.cli import convert
from mraudio_tpu_torch.cli import evaluate as cli_evaluate
from mraudio_tpu_torch.cli import serve as cli_serve
from mraudio_tpu_torch.config import RunConfig, tiny_data_config, tiny_model_config
from mraudio_tpu_torch.models.convert_jax import flax_params
from mraudio_tpu_torch.train import checkpoint as ckpt
from test_torch_train_loss import f32_cfg, jax_tree, port_model

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Annotations, both packages' configs and stores of one tree, and one
    trained checkpoint in each package's format."""
    root = tmp_path_factory.mktemp("trained")
    gt = root / "gt.jsonl"
    gt.write_text("".join(json.dumps({
        "vid": f"v{i}", "qid": i, "query": f"a person does action {i}", "duration": 150 - 7 * i,
        "relevant_windows": [[10 + i, 30 + i]]}) + "\n" for i in range(3)))
    tcfg = RunConfig(model=f32_cfg(tiny_model_config(), saliency=True),
                     data=tiny_data_config(n_frms=4))
    jcfg = JRunConfig(model=f32_cfg(j_tiny(), saliency=True), data=j_tiny_data(n_frms=4))
    (root / "port.json").write_text(json.dumps(tcfg.to_dict()))
    (root / "jax.yaml").write_text(yaml.safe_dump(jcfg.to_dict()))
    model = port_model(tcfg.model, tcfg.data.audio, seed=11)
    store = convert.save_param_store(str(root / "store.pt"), model, convert.store_meta(tcfg))
    j_store = j_save_store(str(root / "jax_store"), jax_tree(model),
                           {"model_name": jcfg.model_name})
    rng = np.random.default_rng(12)
    trained = {tuple(k.split("/")): (rng.standard_normal(v.shape) * 0.2).astype(np.float32)
               for k, v in flax_params(model).items()
               if any(s in k for s in ("lora_a", "lora_b", "saliency_head"))}
    j_path = j_save_checkpoint(str(root / "jax_ckpt"), "best", trained,
                               {"count": np.zeros((), np.int32)}, 3)
    restored = j_load_checkpoint(j_path)
    path = ckpt.save_checkpoint(str(root / "port_ckpt"), "best",
                                {"/".join(k): torch.from_numpy(np.asarray(v))
                                 for k, v in restored["model"].items()},
                                {}, int(restored["epoch"]))
    return root, gt, store, j_store, path, j_path, trained


def test_checkpoint_file_round_trips(setup, tmp_path):
    _, _, _, _, path, _, trained = setup
    payload = ckpt.load_checkpoint(path + ckpt.META_SUFFIX)
    assert payload["epoch"] == 3
    assert sorted(payload["model"]) == sorted("/".join(k) for k in trained)
    for k, v in trained.items():
        assert np.array_equal(payload["model"]["/".join(k)].numpy(), v)
    model = port_model(f32_cfg(tiny_model_config(), saliency=True), tiny_data_config().audio)
    ckpt.apply_trainable(model, payload["model"])
    np.testing.assert_array_equal(model.saliency_head.fc2.bias.detach().numpy(),
                                  trained[("saliency_head", "fc2", "bias")])
    with pytest.raises(KeyError, match="not in model"):
        ckpt.apply_trainable(model, {"llm/layer_9/mlp/up_proj/lora_a": torch.zeros(1)})


def test_evaluate_jsonl_matches_jax_with_saliency(setup, tmp_path):
    root, gt, store, j_store, path, j_path, _ = setup
    common = ["--annotation-file", str(gt), "--batch-size", "2", "--num-workers", "1",
              "--video-source", "synthetic"]
    ours, theirs = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    cli_evaluate.main([*common, "--output-file", str(ours), "--config", str(root / "port.json"),
                       "--params-store", store, "--checkpoint", path, "--device", "cpu"])
    j_cli_evaluate.main([*common, "--output-file", str(theirs), "--config",
                         str(root / "jax.yaml"), "--params-store", j_store,
                         "--checkpoint", j_path])
    records = [json.loads(line) for line in ours.read_text().splitlines()]
    j_records = [json.loads(line) for line in theirs.read_text().splitlines()]
    assert len(records) == 3 and all(len(r["pred_saliency_scores"]) == int(r["qid"] * -3.5 + 75)
                                     for r in records)
    # the saliency scores read the video tokens, which carry the Q-Former
    # projection's bf16 rounding (ROADMAP.md C.3): equal within 1e-5
    for r, j in zip(records, j_records):
        np.testing.assert_allclose(r.pop("pred_saliency_scores"),
                                   j.pop("pred_saliency_scores"), rtol=0, atol=1e-5)
    # every other byte of every line is the same
    assert [json.dumps(r) for r in records] == [json.dumps(j) for j in j_records]


def test_serve_records_equal_jax(setup, tmp_path):
    root, gt, store, j_store, path, j_path, _ = setup
    common = ["--annotation-file", str(gt), "--video-source", "synthetic", "--slots", "2"]
    ours, theirs = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    cli_serve.main([*common, "--output-file", str(ours), "--config", str(root / "port.json"),
                    "--params-store", store, "--checkpoint", path, "--device", "cpu"])
    j_cli_serve.main([*common, "--output-file", str(theirs), "--config", str(root / "jax.yaml"),
                      "--params-store", j_store, "--checkpoint", j_path])

    def strip(p):
        return sorted(({k: v for k, v in json.loads(line).items() if k != "latency_s"}
                       for line in p.read_text().splitlines()), key=lambda r: r["qid"])

    assert len(strip(ours)) == 3
    assert strip(ours) == strip(theirs)
