"""The port's parallelism (``parallel/``) against one device and against
the JAX package on the same (data, model) mesh.

The JAX package runs on this process's 8 virtual CPU devices; the port
runs one process per device, 4 of them on a 2 x 2 mesh over gloo
(``test_torch_parallel_ranks.py``, launched once for the module), on
the tiny model in f32 with a non-zero LoRA B.  Tolerances:

* tokens (greedy under every variant, grammar and lookup decoding,
  ``run_inference`` records) — equal;
* the global batch's loss — within rel 1e-5 of JAX's sharded loss and
  of its one-device loss; each gradient within 1e-4 of its leaf's
  largest |g| of JAX's one-device gradient (``test_torch_train_loss.
  py``'s bound: f32 sums in another order), and within 3e-2 of JAX's
  sharded one: GSPMD sums its sharded gradients in another order again,
  and on this model they sit about 2e-2 of a leaf's largest |g| from the
  one-device ones;
* the trainer's first epoch (one Adam update) — losses within rel 2e-6
  of the JAX ``Trainer``'s on its 2 x 2 mesh and the trained leaves
  within 1e-4 of their largest |leaf| (ROADMAP.md C.3's bound after one
  update); two epochs against the port's own one-device run — losses
  within rel 1e-6 and leaves within 1e-5 of their largest |leaf| (the
  row-parallel sums and the data ranks' gradient sum add in another
  order).

VideoLLaMA (``--model VideoLLaMA`` of the tiny config with 4 query heads
over 2 KV heads and q/k/v biases, so each model rank holds 2 query heads
over 1 KV head) runs on the same ranks under the same tolerances, but for
its connector's and audio projector's gradients against JAX's one-device
ones: bf16 products in both packages, held at 2^-6 of the leaf's largest
|g| (ROADMAP.md C.5).  Those replicated leaves are fed by the sharded
decoder's input gradient: their gradients must come out whole (equal
within each model group before the data ranks' sum) and equal on every
rank after it.
"""

import json

import numpy as np
import pytest

import jax
import torch

from mraudio_tpu.config import MeshConfig as JMeshConfig
from mraudio_tpu.config import RunConfig as JRunConfig
from mraudio_tpu.config import tiny_data_config as j_tiny_data
from mraudio_tpu.models.factory import build_model as j_build_model
from mraudio_tpu.models.xinstructblip import XInstructBLIP as JModel
from mraudio_tpu.parallel import make_mesh as j_make_mesh
from mraudio_tpu.parallel import param_shardings
from mraudio_tpu.parallel import shard_params as j_shard_params
from mraudio_tpu.train.optim import merge_params as j_merge
from mraudio_tpu.train.optim import split_trainable as j_split
from mraudio_tpu.train.trainer import Trainer as JTrainer
from mraudio_tpu_torch import parallel
from mraudio_tpu_torch.config import MeshConfig, RunConfig, tiny_data_config
from mraudio_tpu_torch.infer.evaluate import run_inference
from mraudio_tpu_torch.models.convert_jax import flax_params, torch_name
from mraudio_tpu_torch.ops.image import sample_crop_params
from mraudio_tpu_torch.train.checkpoint import load_checkpoint
from mraudio_tpu_torch.train.trainer import Trainer
from test_torch_parallel_ranks import (BATCH, VARIANTS, VL_VARIANTS, annotations, f32_config,
                                       global_batch, launch, run_once, seeded_model,
                                       seeded_videollama, trainer_config, vl_config,
                                       vl_trainer_config, write_annotations)
from test_torch_train_loss import jax_tree

torch.set_num_threads(1)

SCENARIOS = ["generate", "decoders", "loss", "train", "infer", "gather", "mesh_errors",
             "vl_generate", "vl_loss", "vl_train"]


def _jax_cfg(cfg):
    """The JAX package's config of a port config with the same fields."""
    return JRunConfig.from_dict(cfg.to_dict())


def _run_cfg(model_cfg):
    """A port RunConfig of ``model_cfg`` over the tiny data."""
    return RunConfig(model=model_cfg, data=tiny_data_config(n_frms=4))


def _jax_model(model_cfg):
    return JModel(_jax_cfg(_run_cfg(model_cfg)).model, audio_cfg=j_tiny_data(n_frms=4).audio)


def _mesh_run(out):
    write_annotations(out / "train.jsonl", 4)
    write_annotations(out / "val.jsonl", 3, 4)
    crop = sample_crop_params(np.random.default_rng(5), BATCH, 28, 28, 0.5, 1.0)
    (out / "crop.json").write_text(json.dumps(crop.tolist()))
    cfg = trainer_config(out / "train_single", out / "train.jsonl", out / "val.jsonl")
    Trainer(cfg, model=seeded_model(cfg.model), device="cpu").train()
    cfg = vl_trainer_config(out / "vl_train_single", out / "train.jsonl", out / "val.jsonl")
    Trainer(cfg, model=seeded_videollama(cfg), device="cpu").train()
    launch(out, 2, 2, SCENARIOS)


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    """The 2 x 2 run's directory (once per session), after the one-device
    trainer run the ranks resume from."""
    return run_once(tmp_path_factory, "torch_mesh_2x2", _mesh_run)


def _per_rank(out, name):
    return [json.load(open(out / f"{name}_{r}.json")) for r in range(4)]


def _events(path, kind):
    return [e for e in map(json.loads, open(path / "train.jsonl")) if e["event"] == kind]


# ---------------------------------------------------------------------------
# the mesh and the partition rules (no process group)


def test_a_launch_needs_its_environment_and_a_card(monkeypatch):
    """Without a launcher's environment the process group is refused, and
    on a machine without a card a CUDA group is too: nothing falls back to
    the CPU."""
    from mraudio_tpu_torch.device import init_distributed

    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="needs a distributed launch"):
        init_distributed("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            init_distributed("cuda")


def test_make_mesh_shapes_and_errors(out):
    """One process is a 1 x 1 mesh; any other size raises with the JAX
    package's wording, here and on a launch of 4 (``mesh_errors``)."""
    mesh = parallel.make_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.rank == 0
    assert parallel.make_mesh(MeshConfig()).num_devices == 1
    with pytest.raises(ValueError, match="mesh 2x4 needs 8 devices, have 1"):
        parallel.make_mesh(MeshConfig(data=2, model=4))
    assert parallel.local_batch_size(4, parallel.Mesh(data=2, model=2)) == 2
    with pytest.raises(ValueError, match="not divisible by data=2"):
        parallel.local_batch_size(3, parallel.Mesh(data=2, model=2))
    for msgs in _per_rank(out, "mesh_errors"):
        assert [m.split(" (")[0] for m in msgs] == ["mesh 2x1 needs 2 devices, have 4",
                                                     "mesh 4x2 needs 8 devices, have 4"]


@pytest.mark.parametrize("shape", [(2, 4), (2, 2), (4, 1)])
@pytest.mark.parametrize("llm, stacked", [
    ({}, False), ({"quantization": "int8"}, False),
    ({"quantization": "int4", "int4_group_size": 16}, False), ({"scan_layers": True}, True),
    ("videollama", False),
])
def test_partition_specs_match_param_shardings(shape, llm, stacked):
    """Every leaf's spec equals the JAX package's ``param_shardings`` on a
    mesh of the same shape: the TP rules on the float, int8, int4 and
    LoRA leaves, the vocab-sharded lm_head and embedding, FSDP over the
    encoders, the ``scan_layers`` shift, and with ``fsdp_encoders`` off;
    and on a VideoLLaMA tree (grouped-query attention with q/k/v biases,
    which no rule names: replicated in both specs, sliced with their
    projection by ``shard_module_``; the trainable connector and audio
    projector replicated, its towers under FSDP)."""
    model = (seeded_videollama(vl_config()) if llm == "videollama"
             else seeded_model(f32_config(llm)))
    flat = flax_params(model, stacked=stacked)
    tree = jax_tree(model) if not stacked else None
    if tree is None:
        tree = {}
        for name, t in flat.items():
            node = tree
            *scopes, leaf = name.split("/")
            for s in scopes:
                node = node.setdefault(s, {})
            node[leaf] = np.zeros(t.shape, np.int8)
    mesh = j_make_mesh(JMeshConfig(data=shape[0], model=shape[1]))
    mesh_shape = {"data": shape[0], "model": shape[1]}
    for fsdp in (True, False):
        want = {"/".join(str(getattr(p, "key", p)) for p in path): tuple(s.spec)
                for path, s in jax.tree_util.tree_leaves_with_path(
                    param_shardings(tree, mesh, fsdp_encoders=fsdp))}
        got = parallel.param_specs(flat, mesh_shape, fsdp_encoders=fsdp)
        assert sorted(got) == sorted(want)
        assert got == want
    assert any("model" in s for s in got.values())
    if llm == "videollama":
        assert got["llm/layer_0/attn/q_proj/bias"] == ()
        assert all(s == () for k, s in got.items() if k.startswith(("connector/", "audio_proj/")))


# ---------------------------------------------------------------------------
# the 2 x 2 run


def _mesh_tokens(per_rank, pick=lambda r: r):
    """The global batch's rows from the data ranks; the model ranks of a
    data group must agree."""
    assert pick(per_rank[0]) == pick(per_rank[1]) and pick(per_rank[2]) == pick(per_rank[3])
    return np.asarray(pick(per_rank[0]) + pick(per_rank[2]))


def _one_device_tokens(cfg):
    model = seeded_model(cfg)
    return model.generate_submit(batch=global_batch())[0].numpy()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_generate_matches_one_device_and_jax(out, variant):
    """2 x 2 greedy tokens equal the port's one-device tokens and JAX
    ``generate``'s on a 2 x 2 mesh: in the default configuration, under
    the Pallas routes, ``chunked``, ``seq_shard`` (which reduce-scatters
    the residual stream on the mesh) and ``kv_keep``."""
    per_rank = _per_rank(out, "generate")
    tokens = _mesh_tokens(per_rank, lambda r: r[variant]["tokens"])
    cfg = f32_config(VARIANTS[variant])
    np.testing.assert_array_equal(tokens, _one_device_tokens(cfg))
    sp = [r[variant]["scatter_seq"] for r in per_rank]
    assert all(n > 0 for n in sp) if variant == "seq_shard" else not any(sp)
    model = seeded_model(cfg)
    jmodel = _jax_model(cfg)
    mesh = j_make_mesh(JMeshConfig(data=2, model=2))
    with jax.set_mesh(mesh):
        texts = jmodel.generate(j_shard_params(jax_tree(model), mesh), global_batch())
    assert texts == model.generate_finalize((torch.from_numpy(tokens), None))


def test_decoders_keep_their_identities_under_a_model_axis(out):
    """Under ``model = 2`` grammar decoding at ``spec_width`` 4 gives
    ``spec_width`` 1's tokens and lookup decoding gives greedy's, each
    equal to the one-device port's."""
    per_rank = _per_rank(out, "decoders")
    got = {k: _mesh_tokens(per_rank, lambda r: r[k]) for k in per_rank[0]}
    np.testing.assert_array_equal(got["grammar4"], got["grammar1"])
    np.testing.assert_array_equal(got["lookup"], got["greedy"])
    np.testing.assert_array_equal(got["greedy"], _one_device_tokens(f32_config(
        max_new_tokens=12)))
    np.testing.assert_array_equal(got["grammar1"], _one_device_tokens(f32_config(
        max_new_tokens=12, constrained_decoding=True, spec_width=1)))


def test_loss_and_grads_match_jax_sharded(out):
    """The 2 x 2 loss of the global batch (the data ranks' parts summed)
    and its gradients (summed over the data ranks, the replicated LoRA
    leaves also over the model ranks, then gathered) against JAX's loss
    and ``value_and_grad`` on a 2 x 2 mesh, with the same crops."""
    cfg = f32_config(saliency_head=True)
    model = seeded_model(cfg)
    jmodel = _jax_model(cfg)
    crop = np.asarray(json.load(open(out / "crop.json")), np.float32)
    mesh = j_make_mesh(JMeshConfig(data=2, model=2))
    got = np.load(out / "loss.npz")

    def value_and_grads(params):
        trainable, frozen = j_split(params, jmodel.TRAINABLE_PATTERN)
        value, grads = jax.value_and_grad(lambda tr: jmodel.loss(
            j_merge(tr, frozen), global_batch(), crop_params=crop))(trainable)
        return np.asarray(value), {"/".join(k): np.asarray(v) for k, v in grads.items()}

    one = value_and_grads(jax_tree(model))
    with jax.set_mesh(mesh):
        sharded = value_and_grads(j_shard_params(jax_tree(model), mesh))
    for (value, grads), bound in ((one, 1e-4), (sharded, 3e-2)):
        np.testing.assert_allclose(got["loss"], value, rtol=1e-5)
        assert sorted(grads) == sorted(k.replace("|", "/") for k in got.files if k != "loss")
        for k, g in grads.items():
            assert np.abs(got[k.replace("/", "|")] - g).max() <= bound * np.abs(g).max(), k


def _leaves(path):
    return load_checkpoint(str(path))["model"]


def test_trainer_matches_jax_trainer_on_the_mesh(out, tmp_path):
    """The 2 x 2 trainer's first epoch against the JAX ``Trainer``'s on a
    2 x 2 mesh, and both epochs against the port on one device; rank 0
    alone writes the run log and the checkpoints, which hold the full
    leaves."""
    anns = (str(out / "train.jsonl"), str(out / "val.jsonl"))
    cfg = trainer_config(tmp_path, *anns, mesh=MeshConfig(data=2, model=2), max_epoch=1)
    jcfg = _jax_cfg(cfg)
    jtrainer = JTrainer(jcfg, model=JModel(jcfg.model, audio_cfg=jcfg.data.audio),
                        params=jax_tree(seeded_model(cfg.model)))
    try:
        jtrainer.train()
    finally:
        jtrainer._mesh_ctx.__exit__(None, None, None)     # the JAX trainer leaves it entered
    mesh_run, single = out / "train_mesh", out / "train_single"
    losses = [e["loss"] for e in _events(mesh_run, "train_step")]
    assert len(losses) == 4
    np.testing.assert_allclose(losses[:2], [e["loss"] for e in _events(tmp_path, "train_step")],
                               rtol=2e-6)
    first = _leaves(mesh_run / "checkpoint_0")
    for k, v in jtrainer.trainable.items():
        v = np.asarray(v)
        assert np.abs(first["/".join(k)].numpy() - v).max() <= 1e-4 * np.abs(v).max(), k
    np.testing.assert_allclose(losses, [e["loss"] for e in _events(single, "train_step")],
                               rtol=1e-6)
    np.testing.assert_allclose([e["grad_norm"] for e in _events(mesh_run, "train_step")],
                               [e["grad_norm"] for e in _events(single, "train_step")],
                               rtol=1e-5)
    final, want = _leaves(mesh_run / "checkpoint_1"), _leaves(single / "checkpoint_1")
    assert sorted(final) == sorted(want)
    for k, v in want.items():
        assert final[k].shape == v.shape
        assert (final[k] - v).abs().max() <= 1e-5 * v.abs().max(), k
    assert sorted(p.name for p in mesh_run.iterdir()) == sorted(
        p.name for p in single.iterdir())


def test_mesh_checkpoint_resumes_on_one_device_and_back(out, tmp_path):
    """The mesh's ``checkpoint_0`` resumed on one device, and the one-
    device ``checkpoint_0`` resumed on the mesh (``resume_mesh``), each
    finish as the uninterrupted runs do."""
    anns = (str(out / "train.jsonl"), str(out / "val.jsonl"))
    cfg = trainer_config(tmp_path, *anns,
                         resume_ckpt_path=str(out / "train_mesh" / "checkpoint_0"))
    trainer = Trainer(cfg, model=seeded_model(cfg.model), device="cpu")
    assert (trainer.start_epoch, trainer.global_step) == (1, 2)
    trainer.train()
    want = _leaves(out / "train_mesh" / "checkpoint_1")
    for got in (_leaves(tmp_path / "checkpoint_1"), _leaves(out / "resume_mesh" /
                                                           "checkpoint_1")):
        for k, v in want.items():
            assert (got[k] - v).abs().max() <= 1e-5 * v.abs().max(), k
    assert len(_events(out / "resume_mesh", "train_step")) == 2


def test_run_inference_on_the_mesh_equals_one_device(out):
    """5 annotations at a global batch of 4 on 2 x 2: rank 0 writes the
    one-device records in annotation order, and every rank returns them."""
    cfg = f32_config()
    want = run_inference(_run_cfg(cfg), model=seeded_model(cfg),
                         annotations=annotations(5), batch_size=BATCH, num_workers=1,
                         device="cpu")["records"]
    assert [json.loads(line) for line in open(out / "infer_mesh.jsonl")] == want
    assert all(r == want for r in _per_rank(out, "infer"))


def test_allgather_results_ragged(out):
    """Ragged record lists (one empty, unicode in one) come back on every
    rank in rank order, as ``tests/test_multihost_gather.py`` holds the
    JAX package's."""
    want = [{"qid": 0, "query": "émoji ✓"}, {"qid": 1}, {"qid": 2, "w": [[3, 9]]}, {"qid": 3}]
    assert all(r == want for r in _per_rank(out, "gather"))


# ---------------------------------------------------------------------------
# VideoLLaMA on the 2 x 2 run


def _vl_one_device_tokens(name):
    model = seeded_videollama(vl_config(VL_VARIANTS.get(name)))
    if name == "lookup":
        model.cfg = model.cfg.replace(lookup_spec=4)
    return model.generate_submit(batch=global_batch()).numpy()


@pytest.mark.parametrize("variant", [*VL_VARIANTS, "lookup"])
def test_videollama_generate_matches_one_device_and_jax(out, variant):
    """VideoLLaMA's 2 x 2 greedy tokens equal the port's one-device tokens
    in the default routes, the Pallas routes, under ``kv_keep`` (SnapKV's
    per-head sums added in rank order) and with ``lookup_spec=4``; each
    cache the decoders allocate holds the rank's one KV head (the 2 KV
    heads split, each repeated to its 2 query heads after the slice); in
    the default routes the tokens equal JAX ``generate_submit``'s on a
    2 x 2 mesh."""
    per_rank = _per_rank(out, "vl_generate")
    tokens = _mesh_tokens(per_rank, lambda r: r[variant]["tokens"])
    np.testing.assert_array_equal(tokens, _vl_one_device_tokens(variant))
    assert all(r[variant]["cache_kv_heads"] == [1] for r in per_rank)
    if variant == "default":
        cfg = vl_config()
        jm = j_build_model(_jax_cfg(cfg))
        mesh = j_make_mesh(JMeshConfig(data=2, model=2))
        tree = jax.tree_util.tree_map(jax.numpy.asarray, jax_tree(seeded_videollama(cfg)))
        with jax.set_mesh(mesh):
            j_tokens = np.asarray(jm.generate_submit(j_shard_params(tree, mesh), global_batch()))
        np.testing.assert_array_equal(tokens, j_tokens)


def test_videollama_loss_and_grads_match_jax_sharded(out):
    """VideoLLaMA's 2 x 2 loss and gradients (as the trainer takes them)
    against JAX's ``value_and_grad`` on one device and on a 2 x 2 mesh,
    with the same crops; the connector's and audio projector's gradients
    whole within each model group and equal on every rank."""
    import re

    cfg = vl_config()
    model = seeded_videollama(cfg)
    jm = j_build_model(_jax_cfg(cfg))
    crop = np.asarray(json.load(open(out / "crop.json")), np.float32)
    arrays = [jax.numpy.asarray(a) for a in model.loss_arrays(global_batch())]
    mesh = j_make_mesh(JMeshConfig(data=2, model=2))
    got = np.load(out / "vl_loss.npz")

    def value_and_grads(params):
        trainable, frozen = j_split(params, model.TRAINABLE_PATTERN)
        value, grads = jax.value_and_grad(lambda tr: jm._loss_fn(
            j_merge(tr, frozen), *arrays, crop_params=crop, n_frms=4))(trainable)
        return np.asarray(value), {"/".join(k): np.asarray(v) for k, v in grads.items()}

    one = value_and_grads(jax_tree(model))
    with jax.set_mesh(mesh):
        sharded = value_and_grads(j_shard_params(jax_tree(model), mesh))
    for (value, grads), lora_bound, bf16_bound in ((one, 1e-4, 2.0 ** -6),
                                                    (sharded, 3e-2, 3e-2)):
        np.testing.assert_allclose(got["loss"], value, rtol=1e-5)
        assert sorted(grads) == sorted(k.replace("|", "/") for k in got.files if k != "loss")
        assert any(k.startswith("connector/") for k in grads)
        for k, g in grads.items():
            bound = bf16_bound if re.match(r"(connector|audio_proj)/", k) else lora_bound
            assert np.abs(got[k.replace("/", "|")] - g).max() <= bound * np.abs(g).max(), k
    ranks = [np.load(out / f"vl_replicated_{r}.npz") for r in range(4)]
    assert len(ranks[0].files) == 16
    for k in ranks[0].files:
        if k.startswith("local|"):      # ranks (d, 0) and (d, 1) hold the same whole gradient
            assert np.array_equal(ranks[0][k], ranks[1][k]) and np.array_equal(ranks[2][k],
                                                                               ranks[3][k]), k
        else:
            assert all(np.array_equal(ranks[0][k], r[k]) for r in ranks[1:]), k
            np.testing.assert_array_equal(ranks[0][k], got[k[len("summed|"):]])


def test_videollama_trainer_on_the_mesh_matches_one_device(out):
    """One epoch of the VideoLLaMA trainer on 2 x 2 against the port on one
    device: losses within rel 1e-6, the LoRA leaves within 1e-5 of their
    largest |leaf|; the connector's and audio projector's gradients are
    bf16 products fed by an input gradient that the model ranks sum in
    another order, so those leaves, and the gradients' global norm that
    carries them (each replicated leaf counted once), are held at C.5's
    2^-6 (on this model 4.4e-3 of a leaf's largest |leaf| and 1.1e-4 of
    the norm); the connector and audio projector moved and equal, bit
    for bit, on every rank."""
    mesh_run, single = out / "vl_train_mesh", out / "vl_train_single"
    steps = _events(mesh_run, "train_step")
    assert len(steps) == 2
    np.testing.assert_allclose([e["loss"] for e in steps],
                               [e["loss"] for e in _events(single, "train_step")], rtol=1e-6)
    np.testing.assert_allclose([e["grad_norm"] for e in steps],
                               [e["grad_norm"] for e in _events(single, "train_step")],
                               rtol=2.0 ** -6)
    final, want = _leaves(mesh_run / "checkpoint_0"), _leaves(single / "checkpoint_0")
    assert sorted(final) == sorted(want)
    for k, v in want.items():
        bound = 2.0 ** -6 if k.startswith(("connector/", "audio_proj/")) else 1e-5
        assert (final[k] - v).abs().max() <= bound * v.abs().max(), k
    start = {k: p.detach() for k, p in seeded_videollama(vl_config()).named_parameters()}
    ranks = [np.load(out / f"vl_train_leaves_{r}.npz") for r in range(4)]
    assert len(ranks[0].files) == 8
    for k in ranks[0].files:
        assert all(np.array_equal(ranks[0][k], r[k]) for r in ranks[1:]), k
        assert not np.array_equal(ranks[0][k], start[torch_name(tuple(k.split("|")))].numpy()), k
