"""Megatron sequence parallelism in the port (``LlamaConfig.seq_shard``;
``parallel/comm.py``'s S-axis collectives), on a 1 x 2 mesh of CPU
processes over gloo (``test_torch_parallel_ranks.py``, launched once).

* The S-axis collectives on a ragged 7-token sequence (the last chunk
  zero-padded): split, all-gather and reduce-scatter against numpy.
* The tiny f32 decoder with LoRA: logits and LoRA gradients with
  ``seq_shard`` equal the same mesh's without it bit for bit (two ranks'
  partials add the same either way); the logits equal JAX's ``seq_shard``
  forward on a 1 x 2 mesh within rel 2e-5 / atol 2e-5 (``tests/
  test_seq_shard.py``'s bound) and the gradients JAX's within 1e-4 of
  each leaf's largest |g| (f32 sums in another order).  It is a no-op
  below 2 tokens per rank.
* The evaluate CLI under ``torch.distributed.run`` on a 1 x 2 mesh with
  ``--seq-shard`` writes the one-device CLI's JSONL (the f32 tiny model:
  equal bytes).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mraudio_tpu.config import LlamaConfig as JLlamaConfig
from mraudio_tpu.config import LoraConfig as JLoraConfig
from mraudio_tpu.config import MeshConfig as JMeshConfig
from mraudio_tpu.models.llama import LlamaModel as JLlamaModel
from mraudio_tpu.parallel import make_mesh as j_make_mesh
from mraudio_tpu.parallel import shard_params as j_shard_params
from mraudio_tpu_torch.cli import evaluate as cli_evaluate
from mraudio_tpu_torch.config import MeshConfig, RunConfig, tiny_data_config
from mraudio_tpu_torch.models.convert_jax import flax_params, init_random_, nested, torch_name
from test_torch_parallel_ranks import (REPO, S, decoder, f32_config, launch, run_once,
                                       write_annotations)

torch.set_num_threads(1)


def _seq_run(out):
    holder = decoder()
    init_random_(holder, seed=5)
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for name, p in holder.named_parameters():
            if name.endswith("lora_b"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    torch.save(holder.state_dict(), out / "llm_state.pt")
    rng = np.random.default_rng(0)
    cfg = holder.llm.cfg
    np.savez(out / "llm_inputs.npz",
             emb=rng.standard_normal((2, S, cfg.hidden_size)).astype(np.float32),
             probe=rng.standard_normal((2, S, cfg.padded_vocab_size)).astype(np.float32))
    launch(out, 1, 2, ["seq_layers"])


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    """The 1 x 2 run's directory (once per session)."""
    return run_once(tmp_path_factory, "torch_mesh_1x2", _seq_run)


def _ranks(out):
    return [json.load(open(out / f"seq_layers_{r}.json")) for r in range(2)]


def test_seq_collectives_on_a_ragged_sequence(out):
    for r, res in enumerate(_ranks(out)):
        x = [np.arange(2 * S * 3, dtype=np.float32).reshape(2, S, 3) + k for k in range(2)]
        padded = np.pad(x[r], ((0, 0), (0, 1), (0, 0)))
        np.testing.assert_array_equal(res["chunk"], padded[:, 4 * r:4 * r + 4])
        # the gathered sequence is every rank's own chunk, in rank order
        np.testing.assert_array_equal(
            res["gathered"], np.concatenate([np.pad(x[k], ((0, 0), (0, 1), (0, 0)))[
                :, 4 * k:4 * k + 4] for k in range(2)], axis=1)[:, :S])
        total = np.pad(x[0] + x[1], ((0, 0), (0, 1), (0, 0)))
        np.testing.assert_array_equal(res["scattered"], total[:, 4 * r:4 * r + 4])


def test_seq_shard_is_bitwise_the_tensor_parallel_layout(out):
    for res in _ranks(out):
        assert res["sp"]["sp"] and not res["base"]["sp"]
        assert res["sp"]["logits"] == res["base"]["logits"]
        assert res["sp"]["grads"] == res["base"]["grads"]
        assert res["gates"] == [False, False, True, True]
    a, b = _ranks(out)
    assert a["sp"] == b["sp"]


def test_seq_shard_matches_jax_seq_shard(out):
    """The logits against JAX's ``seq_shard`` forward on a 1 x 2 mesh, the
    LoRA gradients against JAX's ``value_and_grad`` of the same function
    (``seq_shard`` changes the layout, not the function)."""
    holder = decoder()
    holder.load_state_dict(torch.load(out / "llm_state.pt", weights_only=True))
    inputs = np.load(out / "llm_inputs.npz")
    cfg = JLlamaConfig.from_dict(f32_config({"seq_shard": True}).llm.to_dict())
    model = JLlamaModel(cfg, JLoraConfig.from_dict(f32_config().lora.to_dict()))
    mask = jnp.tril(jnp.ones((S, S), bool))[None, None]
    pos = jnp.broadcast_to(jnp.arange(S), (2, S))
    params = {k.split("/", 1)[1]: v.numpy() for k, v in flax_params(holder).items()}
    trainable = {k: v for k, v in params.items() if "lora" in k}

    def logits_of(flat):
        return model.apply({"params": nested(flat)}, inputs["emb"], mask, pos)[0]

    mesh = j_make_mesh(JMeshConfig(data=1, model=2))
    with jax.set_mesh(mesh):
        placed = j_shard_params({"llm": nested(params)}, mesh)["llm"]
        logits = jax.jit(lambda p: model.apply({"params": p}, inputs["emb"], mask, pos)[0])(
            placed)
    grads = jax.grad(lambda tr: (logits_of({**params, **tr}) * inputs["probe"]).sum())(
        trainable)
    res = _ranks(out)[0]["sp"]
    np.testing.assert_allclose(res["logits"], np.asarray(logits), rtol=2e-5, atol=2e-5)
    assert len(grads) == len(res["grads"])
    for k, g in grads.items():
        port = np.asarray(res["grads"][torch_name(("llm",) + tuple(k.split("/")))])
        g = np.asarray(g)
        assert np.abs(port - g).max() <= 1e-4 * np.abs(g).max(), k


def test_evaluate_cli_on_a_launch_with_seq_shard(tmp_path):
    """``torch.distributed.run`` of 2 CPU processes, a 1 x 2 mesh config
    and ``--seq-shard``: rank 0 writes the one-device JSONL."""
    ann = write_annotations(tmp_path / "ann.jsonl", 3)
    for name, mesh in (("mesh", MeshConfig(data=1, model=2)), ("one", MeshConfig())):
        (tmp_path / f"{name}.json").write_text(json.dumps(RunConfig(
            model=f32_config(), data=tiny_data_config(n_frms=4), mesh=mesh).to_dict()))
    args = ["--annotation-file", str(ann), "--video-source", "synthetic", "--device", "cpu",
            "--batch-size", "2", "--num-workers", "1"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    run = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc-per-node", "2", "-m", "mraudio_tpu_torch.cli.evaluate",
                          *args, "--config", str(tmp_path / "mesh.json"), "--seq-shard",
                          "--output-file", str(tmp_path / "mesh.jsonl")],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    assert run.stdout.count("wrote 3 predictions") == 1
    cli_evaluate.main([*args, "--config", str(tmp_path / "one.json"), "--output-file",
                       str(tmp_path / "one.jsonl")])
    assert (tmp_path / "mesh.jsonl").read_text() == (tmp_path / "one.jsonl").read_text()
