"""The port's int8 storage of frozen kernels (``models/quant_tree.py``)
against the JAX package's: keys, eligibility, codes, scales and the
dequantized kernels bit for bit (``tests/test_quant_frozen.py``'s
cases, on random weights too); a module quantized in place reads JAX's
dequantized kernels, in the flax layouts (``DenseGeneral``, BEATs'
``pos_conv``); and the trainer with ``quant_frozen="int8"`` against JAX's
at PR 7's tolerances (losses within rel 2e-6, the trained leaves within
1e-4 of their largest |leaf| after one update).  The tiny model's kernels
are below ``MIN_SIZE``, so the tests lower it in both packages."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mraudio_tpu.models import quant_tree as jqt
from mraudio_tpu.models.casting import cast_params_for_inference as j_cast
from mraudio_tpu.models.xinstructblip import XInstructBLIP as JModel
from mraudio_tpu.train.trainer import Trainer as JTrainer
from mraudio_tpu_torch.models import quant_tree as tqt
from mraudio_tpu_torch.models.casting import cast_params_for_inference
from mraudio_tpu_torch.models.convert_jax import _flax_scopes
from mraudio_tpu_torch.train import trainer as trainer_mod
from test_torch_train_loss import jax_tree, port_model
from test_torch_trainer import _events, configs

torch.set_num_threads(1)


def _both(flat: dict):
    """A flat dict of numpy arrays as (JAX arrays, torch tensors)."""
    return ({k: jnp.asarray(v) for k, v in flat.items()},
            {k: torch.from_numpy(np.asarray(v).copy()) for k, v in flat.items()})


def _equal(ours, theirs):
    a = ours.float().numpy() if ours.dtype == torch.bfloat16 else ours.numpy()
    b = np.asarray(jnp.asarray(theirs).astype(jnp.float32) if theirs.dtype == jnp.bfloat16
                   else theirs)
    return a.dtype == b.dtype and np.array_equal(a, b)


def test_eligibility_keys_and_round_trip_match_jax():
    rng = np.random.default_rng(0)
    flat = {
        ("vit", "block_0", "mlp", "fc1", "kernel"): rng.standard_normal((64, 1200)),
        ("vit", "block_0", "mlp", "fc1", "bias"): rng.standard_normal(1200),
        ("vit", "block_0", "attn", "out", "kernel"): rng.standard_normal((16, 64, 80)),
        ("llm", "lm_head", "kernel"): rng.standard_normal((64, 1200)),
        ("llm", "layer_0", "q", "w_int8"): rng.integers(-127, 128, (64, 1200)).astype(np.int8),
        ("vit", "norm", "scale"): np.ones(64),
        ("small", "kernel"): rng.standard_normal((4, 8)),
        ("few_rows", "kernel"): rng.standard_normal((8, 16384)),
        ("zero", "kernel"): np.zeros((32, 4096)),
    }
    flat = {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in flat.items()}
    j_flat, t_flat = _both(flat)
    jq, tq = jqt.quantize_frozen(j_flat), tqt.quantize_frozen(t_flat)
    assert sorted(tq) == sorted(jq)
    assert ("vit", "block_0", "attn", "out", "kernel", "int8") in tq
    assert ("few_rows", "kernel") in tq and ("llm", "lm_head", "kernel") in tq
    for k in tq:
        assert _equal(tq[k], jq[k]), k
    assert tqt.quantized_bytes_saved(tq) == jqt.quantized_bytes_saved(jq) > 0
    jd, td = jqt.dequantize_frozen(jq), tqt.dequantize_frozen(tq)
    assert sorted(td) == sorted(jd) == sorted(flat)
    for k in td:
        assert _equal(td[k], jd[k]), k
    assert td[("vit", "block_0", "mlp", "fc1", "kernel")].dtype == torch.bfloat16
    # on the int8 grid (column absmax 127 * 2^-7) the round trip is exact
    # and re-quantizing gives the same codes, as in JAX
    ints = rng.integers(-127, 128, size=(64, 1024)).astype(np.float32)
    ints[0] = 127.0
    grid = {("m", "kernel"): torch.from_numpy(ints * 2.0 ** -7)}
    q = tqt.quantize_frozen(grid)
    assert torch.equal(q[("m", "kernel", "int8")], torch.from_numpy(ints).to(torch.int8))
    back = tqt.dequantize_frozen(q, dtype=torch.float32)
    assert torch.equal(back[("m", "kernel")], grid[("m", "kernel")])
    assert torch.equal(tqt.quantize_frozen(back)[("m", "kernel", "int8")],
                       q[("m", "kernel", "int8")])


def test_subtrees_match_jax():
    rng = np.random.default_rng(1)
    tree = {"vit": {"block_0": {"fc": {"kernel": rng.standard_normal((64, 2048))}}},
            "beats": {"fc": {"kernel": rng.standard_normal((32, 4096))}},
            "llm": {"up_proj": {"kernel": rng.standard_normal((64, 2048))}}}
    j_tree = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)
    t_tree = jax.tree_util.tree_map(lambda a: torch.from_numpy(a.astype(np.float32)), tree)
    keys = ("vit", "beats")
    jq, tq = jqt.quantize_subtrees(j_tree, keys), tqt.quantize_subtrees(t_tree, keys)
    assert tq["llm"] is t_tree["llm"]
    assert _equal(tq["vit"]["block_0"]["fc"]["kernel"]["int8"],
                  jq["vit"]["block_0"]["fc"]["kernel"]["int8"])
    jd, td = jqt.dequantize_subtrees(jq, keys), tqt.dequantize_subtrees(tq, keys)
    assert _equal(td["beats"]["fc"]["kernel"], jd["beats"]["fc"]["kernel"])
    assert tqt.dequantize_subtrees(t_tree, keys)["vit"] is t_tree["vit"]


def test_module_reads_jax_dequantized_kernels(monkeypatch):
    """``quantize_module_`` on the tiny model's encoders (threshold
    lowered): every kernel the module reads equals JAX's
    ``dequantize_subtrees(quantize_subtrees(...))`` in the flax layout,
    bit for bit; a Q-Former out-projection whose flax axis 0 is 2 heads
    stays float, as in JAX; LoRA and the LLM are untouched."""
    for mod in (jqt, tqt):
        monkeypatch.setattr(mod, "MIN_SIZE", 1024)
        monkeypatch.setattr(mod, "MIN_DIM0", 2)
    from mraudio_tpu_torch.config import tiny_data_config, tiny_model_config

    model = port_model(tiny_model_config(), tiny_data_config().audio)
    j_params = j_cast(jax.tree_util.tree_map(jnp.asarray, jax_tree(model)))
    cast_params_for_inference(model)
    keys = model.ENCODER_PARAM_KEYS
    theirs = jqt.dequantize_subtrees(jqt.quantize_subtrees(j_params, keys), keys)
    saved = tqt.quantize_module_(model, keys=keys)
    assert saved == _flat_saved(jqt.quantize_subtrees(j_params, keys))
    flat_theirs = _flat(theirs)
    quantized = 0
    for mod_name, mod in model.named_modules():
        if not hasattr(mod, "parametrizations"):
            continue
        quantized += 1
        name = "/".join(_flax_scopes(mod_name.split(".")) + ["kernel"])
        assert name.split("/")[0] in keys
        want = torch.from_numpy(np.array(flat_theirs[name].astype(jnp.float32)))
        want = want.permute(2, 1, 0) if mod_name.endswith("pos_conv") else want
        assert torch.equal(mod.kernel.float(), want.reshape(mod.kernel.shape)), name
    assert quantized > 10 and hasattr(model.vit.blocks[0].attn.out, "parametrizations")
    assert hasattr(model.beats.pos_conv, "parametrizations")
    assert not any(hasattr(m, "parametrizations") for m in model.llm.modules())


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = v
    return out


def _flat_saved(tree) -> int:
    return jqt.quantized_bytes_saved({tuple(k.split("/")): v for k, v in _flat(tree).items()})


@pytest.fixture(scope="module")
def anns(tmp_path_factory):
    from test_torch_trainer import _write_ann

    root = tmp_path_factory.mktemp("qann")
    return _write_ann(root / "train.jsonl", 4), _write_ann(root / "val.jsonl", 2, 4)


def test_trainer_quant_frozen_matches_jax(anns, tmp_path, monkeypatch):
    """One epoch (2 micro-steps, 1 update) of both trainers with
    ``quant_frozen="int8"`` from the same parameters (threshold lowered:
    the encoders' and the LLM's frozen kernels are quantized): losses
    within rel 2e-6 and the trained leaves within 1e-4 of their largest
    |leaf|."""
    for mod in (jqt, tqt):
        monkeypatch.setattr(mod, "MIN_SIZE", 2048)
    jcfg, cfg = configs(anns, tmp_path / "port", quant_frozen="int8", max_epoch=1)
    jcfg = jcfg.replace(train=jcfg.train.replace(output_dir=str(tmp_path / "jax")))
    model = port_model(cfg.model, cfg.data.audio)
    params = jax_tree(model)
    ours = trainer_mod.Trainer(cfg, model=model, device="cpu")
    assert any(n.endswith("kernel.original0") and n.startswith("llm.")
               for n, _ in model.named_parameters())
    ours.train_epoch(0)
    theirs = JTrainer(jcfg, model=JModel(jcfg.model, audio_cfg=jcfg.data.audio), params=params)
    assert any(k[-1] == "int8" and k[0] == "llm" for k in theirs.frozen)
    theirs.train_epoch(0)
    losses = [e["loss"] for e in _events(tmp_path / "port", "train_step")]
    j_losses = [e["loss"] for e in _events(tmp_path / "jax", "train_step")]
    assert len(losses) == 2
    np.testing.assert_allclose(losses, j_losses, rtol=2e-6)
    for k, v in theirs.trainable.items():
        want = np.asarray(v)
        got = ours.trainable["/".join(k)].detach().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
