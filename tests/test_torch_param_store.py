"""The port's param store (``cli/convert.py``) against the JAX package's.

The JAX store is orbax; the port's is one ``torch.save`` file with the
same flat names.  From one fabricated tiny checkpoint each package writes
its store (both random inits replaced by one sentinel fill, as in
``test_torch_convert_weights.py``): the two hold the same keys and
bit-identical leaves.  The port's store round-trips into a fresh model,
a meta mismatch raises, and ``cli.convert`` → ``--params-store`` gives
the evaluate CLI the predictions of the convert-at-load path, byte for
byte."""

import json
import sys

import pytest

import torch

import mraudio_tpu.models.convert_weights as jcw
from mraudio_tpu.cli.convert import load_param_store as j_load_store
from mraudio_tpu.cli.convert import save_param_store as j_save_store
from mraudio_tpu.models.xinstructblip import XInstructBLIP as JModel
import mraudio_tpu_torch.models.convert_weights as tcw
from mraudio_tpu_torch.cli import convert as cli_convert
from mraudio_tpu_torch.cli import evaluate as cli_evaluate
from mraudio_tpu_torch.config import RunConfig, tiny_data_config, tiny_model_config
from mraudio_tpu_torch.models.convert_jax import flax_params, load_jax_params_
from mraudio_tpu_torch.models.fabricate import fabricate_checkpoint_dir
from mraudio_tpu_torch.models.factory import build_model
from test_torch_convert_weights import (WEIGHT_FIELDS, _sentinel_, assert_same_leaves,
                                        configs, flat, jax_init_filled)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return fabricate_checkpoint_dir(tiny_model_config(), str(tmp_path_factory.mktemp("ck")))


@pytest.fixture(scope="module")
def port_store(ckpt, tmp_path_factory):
    """(cfg, model, store path): the port's store of the six artifacts."""
    _, tcfg = configs("int8", **{WEIGHT_FIELDS[r]: p for r, p in ckpt.items()})
    mp = pytest.MonkeyPatch()
    mp.setattr(tcw, "init_random_", _sentinel_)
    model = tcw.load_pretrained_params(build_model(tcfg, "cpu"), tcfg)
    mp.undo()
    path = cli_convert.save_param_store(str(tmp_path_factory.mktemp("st") / "store.pt"), model,
                                        cli_convert.store_meta(tcfg))
    return tcfg, model, path


def test_stores_of_both_packages_agree(ckpt, port_store, tmp_path):
    tcfg, model, path = port_store
    jcfg, _ = configs("int8", **{WEIGHT_FIELDS[r]: p for r, p in ckpt.items()})
    with jax_init_filled():
        params = jcw.load_pretrained_params(JModel(jcfg.model, audio_cfg=jcfg.data.audio), jcfg)
    j_path = j_save_store(str(tmp_path / "jax_store"), params, {"model_name": jcfg.model_name})
    ours = torch.load(path, weights_only=True, mmap=True)
    assert all(isinstance(v, torch.Tensor) for v in ours.values())
    assert_same_leaves(ours, flat(j_load_store(j_path)))
    assert_same_leaves(ours, flax_params(model))
    meta = json.loads(open(path + ".meta.json").read())
    assert meta == {"model_name": "X-InstructBLIP", "quantization": "int8", "scan_layers": False}


def test_store_round_trips_and_checks_its_meta(port_store):
    tcfg, model, path = port_store
    fresh = cli_convert.resolve_params(build_model(tcfg, "cpu"), tcfg, path)
    assert_same_leaves(flax_params(fresh), flax_params(model))
    # the model's parameters are copies, not views of the mapped file
    store = cli_convert.load_param_store(path)
    assert store["llm"]["final_norm"]["scale"].data_ptr() != fresh.llm.final_norm.scale.data_ptr()
    wrong = tcfg.replace(model=tcfg.model.replace(llm=tcfg.model.llm.replace(quantization="none")))
    with pytest.raises(ValueError, match="quantization='int8' but this run's config wants 'none'"):
        cli_convert.resolve_params(build_model(wrong, "cpu"), wrong, path)
    # every parameter must be in the store
    del store["llm"]["final_norm"]
    with pytest.raises(KeyError, match="missing"):
        load_jax_params_(build_model(tcfg, "cpu"), store)


def test_convert_cli_store_drives_the_evaluate_cli(ckpt, tmp_path):
    """``cli.convert`` from the six artifacts, then the evaluate CLI with
    ``--params-store``: the same JSONL as the convert-at-load path (a
    YAML naming the artifacts)."""
    yaml = tmp_path / "run.yaml"
    RunConfig(model=tiny_model_config(), data=tiny_data_config(n_frms=4),
              **{WEIGHT_FIELDS[r]: p for r, p in ckpt.items()}).to_yaml(str(yaml))
    store = tmp_path / "store.pt"
    out = cli_convert.main(["--model-size", "tiny", "--output", str(store), "--device", "cpu",
                            "--model-path", ckpt["llm"], "--audio-encoder", ckpt["beats"],
                            "--vit", ckpt["vit"], "--video-qformer", ckpt["video_qformer"],
                            "--audio-qformer", ckpt["audio_qformer"], "--blip2", ckpt["blip2"]])
    assert out == str(store) and (tmp_path / "store.pt.meta.json").exists()
    ann = tmp_path / "ann.jsonl"
    ann.write_text("".join(json.dumps({"vid": f"v{i}", "qid": i, "query": f"action {i}",
                                       "duration": 150, "relevant_windows": [[10, 30]]}) + "\n"
                           for i in range(3)))
    common = ["--annotation-file", str(ann), "--video-source", "synthetic", "--device", "cpu",
              "--num-workers", "1"]
    cli_evaluate.main([*common, "--output-file", str(tmp_path / "a.jsonl"), "--config", str(yaml)])
    cli_evaluate.main([*common, "--output-file", str(tmp_path / "b.jsonl"), "--model-size", "tiny",
                       "--params-store", str(store)])
    assert (tmp_path / "a.jsonl").read_bytes() == (tmp_path / "b.jsonl").read_bytes()


def test_convert_cli_without_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_convert.main(["--model-size", "tiny", "--output", str(tmp_path / "s.pt")])
    assert not (tmp_path / "s.pt").exists()


def test_json_config_loads_without_pyyaml(tmp_path, monkeypatch):
    """A config written as JSON (what ``chip_smoke.py`` hands the CLIs on
    a machine without PyYAML) loads with ``json``: the same config, and
    floats such as ``1e-06`` stay floats."""
    cfg = RunConfig(model=tiny_model_config(), data=tiny_data_config(n_frms=4),
                    llm_weights="/weights/vicuna.pth")
    path = tmp_path / "run.json"
    path.write_text(json.dumps(cfg.to_dict()))
    monkeypatch.setitem(sys.modules, "yaml", None)
    loaded = RunConfig.from_yaml(str(path))
    assert loaded.to_dict() == json.loads(path.read_text())
    assert loaded.model.vit.layer_norm_eps == 1e-6 and loaded.llm_weights == "/weights/vicuna.pth"
