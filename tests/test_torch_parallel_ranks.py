"""The rank program of the port's mesh tests (``test_torch_parallel.py``,
``test_torch_seq_shard.py``), and a launcher for it.

Each rank is a process of its own on the CPU, in a gloo group whose
rendezvous is a file (so that concurrent test workers never share a
port).  It imports torch and the port only, runs the scenarios it is
given on the tiny f32 model and writes what it saw under the output
directory, one file per scenario and rank; the test process compares.

    RANK=r WORLD_SIZE=n python tests/test_torch_parallel_ranks.py OUT D M SCENARIO...
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

from mraudio_tpu_torch import parallel
from mraudio_tpu_torch.config import (MeshConfig, RunConfig, TrainConfig, tiny_data_config,
                                      tiny_model_config)
from mraudio_tpu_torch.data.dataset import MRDataset, collate
from mraudio_tpu_torch.models.convert_jax import init_random_
from mraudio_tpu_torch.models.xinstructblip import XInstructBLIP
from mraudio_tpu_torch.parallel import comm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 4          # the global batch of every scenario
S = 7              # tokens of the sequence-parallel scenario: ragged over 2 ranks
LR = 3e-4

# decoder overrides of the generate scenario's variants
VARIANTS = {
    "default": {},
    "pallas": dict(attention_impl="pallas", decode_gemv="pallas", prefill_chunk=0),
    "chunked": dict(attention_impl="chunked", prefill_chunk=32),
    "seq_shard": dict(seq_shard=True),
    "kv_keep": dict(kv_keep=40, kv_keep_obs=8),
}


def f32_config(llm=None, **kw):
    """The tiny model in f32 with LoRA dropout off, decoder overrides
    ``llm``."""
    cfg = tiny_model_config()
    return cfg.replace(llm=cfg.llm.replace(dtype="float32", **(llm or {})),
                       vit=cfg.vit.replace(dtype="float32"),
                       beats=cfg.beats.replace(dtype="float32"),
                       qformer=cfg.qformer.replace(dtype="float32"),
                       lora=cfg.lora.replace(dropout=0.0), **kw)


def seeded_model(cfg, seed=3):
    """The port's model with seeded weights and a non-zero LoRA B, on the
    CPU."""
    model = XInstructBLIP(cfg, audio_cfg=tiny_data_config().audio, device="cpu")
    init_random_(model, seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_b"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    return model


def annotations(n, start=0):
    return [{"vid": f"v{i}", "qid": i, "query": f"action {i} near the door",
             "duration": 150 - 7 * i, "relevant_windows": [[5 * i % 100, 5 * i % 100 + 10]]}
            for i in range(start, start + n)]


def write_annotations(path, n, start=0):
    with open(path, "w") as f:
        f.write("".join(json.dumps(a) + "\n" for a in annotations(n, start)))
    return path


def global_batch():
    ds = MRDataset(tiny_data_config(n_frms=4), annotations=annotations(BATCH))
    return collate([ds.get(i) for i in range(BATCH)], BATCH)


def rows_of(batch, mesh):
    """A data rank's rows of ``batch``."""
    lb = BATCH // mesh.data
    part = slice(mesh.data_index * lb, (mesh.data_index + 1) * lb)
    return type(batch)(**{f: getattr(batch, f)[part] for f in batch.__dataclass_fields__})


# the tiny VideoLLaMA on the mesh: grouped-query attention (4 query heads
# over 2 KV heads, so 2 over 1 per rank at model = 2) and q/k/v biases, the
# 2.1-AV decoder's features, tiling the model axis
VL_LLM = dict(num_kv_heads=2, attention_bias=True)
# its decoder overrides under which the mesh's tokens are held
VL_VARIANTS = {
    "default": {},
    "pallas": dict(attention_impl="pallas", decode_gemv="pallas", prefill_chunk=0),
    "kv_keep": dict(kv_keep=40, kv_keep_obs=8),
}


def vl_config(llm=None) -> RunConfig:
    """The tiny VideoLLaMA (``--model VideoLLaMA`` of the tiny assembly
    config) in f32 with :data:`VL_LLM` and decoder overrides ``llm``."""
    return RunConfig(model_name="VideoLLaMA", model=f32_config({**VL_LLM, **(llm or {})}),
                     data=tiny_data_config(n_frms=4))


def seeded_videollama(cfg: RunConfig, seed=3):
    """The port's VideoLLaMA of ``cfg`` on the CPU with seeded weights and a
    non-zero LoRA B and decoder biases."""
    from mraudio_tpu_torch.models.factory import build_model

    model = build_model(cfg, "cpu")
    init_random_(model, seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_b") or (name.endswith("bias") and name.startswith("llm.")):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    return model


def trainer_config(out, train_ann, val_ann, mesh=None, **train):
    kw = dict(max_epoch=2, batch_size=2, warmup_steps=2, accum_grad_iters=2, lr=LR,
              output_dir=str(out), val_freq=1, save_freq=1, num_workers=1)
    kw.update(train)
    return RunConfig(model=f32_config(saliency_head=True), train=TrainConfig(**kw),
                     data=tiny_data_config(n_frms=4).replace(train_annotation_file=train_ann,
                                                             val_annotation_file=val_ann),
                     mesh=mesh or MeshConfig())


def decoder(llm=None):
    """The tiny f32 decoder with LoRA, under the top-level name ``llm``
    (the partition rules' scope)."""
    from mraudio_tpu_torch.models.llama import LlamaModel

    holder = torch.nn.Module()
    holder.llm = LlamaModel(f32_config(llm).llm, f32_config().lora)
    return holder


def trainable_names(model) -> list:
    """The flat flax names of the trainable leaves (read before the model
    is sharded: the flax layout of a sliced encoder leaf is unknown)."""
    from mraudio_tpu_torch.models.convert_jax import flax_params

    return [k for k in flax_params(model, stacked=False) if "lora_" in k or "saliency" in k]


def grads_of(model, batch, names, crop=None):
    """The loss and the gradients of the leaves ``names`` as the trainer
    takes them: ``{flax name: gradient}``."""
    from mraudio_tpu_torch.models.convert_jax import torch_name

    params = dict(model.named_parameters())
    leaves = [params[torch_name(tuple(k.split("/")))] for k in names]
    for p in leaves:
        p.requires_grad_(True)
    loss = model.loss(batch=batch, crop_params=crop)
    return loss, dict(zip(names, torch.autograd.grad(loss, leaves)))


# ---------------------------------------------------------------------------
# scenarios: each writes <out>/<scenario>_<rank>.*


def generate(out, mesh, rank):
    """Greedy tokens of this data rank's rows under every variant, and
    how many reduce-scatters sequence parallelism ran."""
    counts = {"scatter_seq": 0}
    real = comm.scatter_seq

    def counting(*a):
        counts["scatter_seq"] += 1
        return real(*a)

    comm.scatter_seq = counting
    res = {}
    for name, llm in VARIANTS.items():
        model = seeded_model(f32_config(llm))
        parallel.shard_module_(model, mesh)
        counts["scatter_seq"] = 0
        tokens, _ = model.generate_submit(batch=rows_of(global_batch(), mesh))
        res[name] = {"tokens": tokens.tolist(), "scatter_seq": counts["scatter_seq"]}
    comm.scatter_seq = real
    json.dump(res, open(f"{out}/generate_{rank}.json", "w"))


def decoders(out, mesh, rank):
    """Greedy, grammar (``spec_width`` 4 and 1) and lookup tokens on the
    mesh."""
    res = {}
    for name, kw in (("greedy", {}), ("grammar4", dict(constrained_decoding=True, spec_width=4)),
                     ("grammar1", dict(constrained_decoding=True, spec_width=1)),
                     ("lookup", dict(lookup_spec=4))):
        model = seeded_model(f32_config(max_new_tokens=12, **kw))
        parallel.shard_module_(model, mesh)
        tokens, _ = model.generate_submit(batch=rows_of(global_batch(), mesh))
        res[name] = tokens.tolist()
    json.dump(res, open(f"{out}/decoders_{rank}.json", "w"))


def loss(out, mesh, rank):
    """The global batch's loss and the full gradients, taken as the
    trainer takes them on a mesh."""
    from mraudio_tpu_torch.models.convert_jax import torch_name

    model = seeded_model(f32_config(saliency_head=True))
    names = trainable_names(model)
    specs = parallel.shard_module_(model, mesh)
    crop = np.asarray(json.load(open(f"{out}/crop.json")), np.float32)
    lb = BATCH // mesh.data
    value, grads = grads_of(model, rows_of(global_batch(), mesh), names,
                            torch.from_numpy(crop[mesh.data_index * lb:][:lb]))
    leaf_specs = {k: specs[torch_name(tuple(k.split("/")))] for k in grads}
    partial = [k for k in grads if k.startswith("llm/") and "model" not in leaf_specs[k]]
    comm.all_reduce_sum_(grads, partial, mesh.model_group)
    comm.all_reduce_sum_(grads, list(grads), mesh.data_group)
    grads = parallel.gather_params(grads, mesh, leaf_specs)
    value = comm.all_reduce_sum(value.detach(), mesh.data_group)
    if rank == 0:
        np.savez(f"{out}/loss.npz", loss=value.numpy(),
                 **{k.replace("/", "|"): v.numpy() for k, v in grads.items()})


def train(out, mesh, rank):
    """Two epochs of the trainer, and the same run resumed from the
    one-device run's ``checkpoint_0``."""
    from mraudio_tpu_torch.train.trainer import Trainer

    anns = (f"{out}/train.jsonl", f"{out}/val.jsonl")
    cfg = trainer_config(f"{out}/train_mesh", *anns, mesh=MeshConfig(mesh.data, mesh.model))
    Trainer(cfg, model=seeded_model(cfg.model), device="cpu").train()
    cfg = trainer_config(f"{out}/resume_mesh", *anns, mesh=MeshConfig(mesh.data, mesh.model),
                         resume_ckpt_path=f"{out}/train_single/checkpoint_0")
    Trainer(cfg, model=seeded_model(cfg.model), device="cpu").train()


def infer(out, mesh, rank):
    """``run_inference`` records of 5 annotations at a global batch of 4
    (the second batch leaves data rank 1 nothing but padding)."""
    from mraudio_tpu_torch.infer.evaluate import run_inference

    cfg = RunConfig(model=f32_config(), data=tiny_data_config(n_frms=4),
                    mesh=MeshConfig(mesh.data, mesh.model))
    result = run_inference(cfg, model=seeded_model(cfg.model), annotations=annotations(5),
                           output_file=f"{out}/infer_mesh.jsonl", batch_size=BATCH,
                           num_workers=1, device="cpu")
    json.dump(result["records"], open(f"{out}/infer_{rank}.json", "w"))


def gather(out, mesh, rank):
    """Ragged record lists (one empty, one with unicode) gathered."""
    mine = [[{"qid": 0, "query": "émoji ✓"}], [{"qid": 1}, {"qid": 2, "w": [[3, 9]]}], [],
            [{"qid": 3}]][rank]
    from mraudio_tpu_torch.train.trainer import _allgather_results

    json.dump(_allgather_results(mine), open(f"{out}/gather_{rank}.json", "w"))


def mesh_errors(out, mesh, rank):
    """A mesh of another size than the launch raises."""
    msgs = []
    for cfg in (MeshConfig(data=2, model=1), MeshConfig(data=4, model=2)):
        try:
            parallel.make_mesh(cfg)
        except ValueError as e:
            msgs.append(str(e))
    json.dump(msgs, open(f"{out}/mesh_errors_{rank}.json", "w"))


def vl_generate(out, mesh, rank):
    """VideoLLaMA's greedy tokens of this data rank's rows under every
    :data:`VL_VARIANTS` entry and with ``lookup_spec=4``, and the KV heads
    of each cache the decoders allocate (this rank's only)."""
    from mraudio_tpu_torch.infer import generate as gen_mod

    heads = []
    real = gen_mod.init_cache

    def recording(cfg, *a, **kw):
        cache = real(cfg, *a, **kw)
        heads.append(int(cache[0]["k"].shape[2]))
        return cache

    gen_mod.init_cache = recording
    res = {}
    for name, llm in {**VL_VARIANTS, "lookup": {}}.items():
        model = seeded_videollama(vl_config(llm))
        if name == "lookup":
            model.cfg = model.cfg.replace(lookup_spec=4)
        parallel.shard_module_(model, mesh)
        heads.clear()
        tokens = model.generate_submit(batch=rows_of(global_batch(), mesh))
        res[name] = {"tokens": tokens.tolist(), "cache_kv_heads": sorted(set(heads))}
    gen_mod.init_cache = real
    json.dump(res, open(f"{out}/vl_generate_{rank}.json", "w"))


def vl_loss(out, mesh, rank):
    """VideoLLaMA's loss of the global batch and its full gradients, taken
    as the trainer takes them; every rank also saves its connector's and
    audio projector's gradients before and after the sum over the data
    ranks (replicated leaves fed by the sharded decoder's input
    gradient)."""
    import re

    from mraudio_tpu_torch.models.convert_jax import flax_params, torch_name

    model = seeded_videollama(vl_config())
    names = [k for k in flax_params(model, stacked=False)
             if re.search(model.TRAINABLE_PATTERN, k)]
    specs = parallel.shard_module_(model, mesh)
    crop = np.asarray(json.load(open(f"{out}/crop.json")), np.float32)
    lb = BATCH // mesh.data
    value, grads = grads_of(model, rows_of(global_batch(), mesh), names,
                            torch.from_numpy(crop[mesh.data_index * lb:][:lb]))
    leaf_specs = {k: specs[torch_name(tuple(k.split("/")))] for k in grads}
    partial = [k for k in grads if k.startswith("llm/") and "model" not in leaf_specs[k]]
    replicated = [k for k in grads if not k.startswith("llm/")]
    mine = {"local|" + k.replace("/", "|"): grads[k].clone().numpy() for k in replicated}
    comm.all_reduce_sum_(grads, partial, mesh.model_group)
    comm.all_reduce_sum_(grads, list(grads), mesh.data_group)
    mine.update({"summed|" + k.replace("/", "|"): grads[k].numpy() for k in replicated})
    np.savez(f"{out}/vl_replicated_{rank}.npz", **mine)
    grads = parallel.gather_params(grads, mesh, leaf_specs)
    value = comm.all_reduce_sum(value.detach(), mesh.data_group)
    if rank == 0:
        np.savez(f"{out}/vl_loss.npz", loss=value.numpy(),
                 **{k.replace("/", "|"): v.numpy() for k, v in grads.items()})


def vl_train(out, mesh, rank):
    """One epoch of the VideoLLaMA trainer on the mesh; every rank saves
    its connector's and audio projector's leaves afterwards."""
    from mraudio_tpu_torch.train.trainer import Trainer

    cfg = vl_trainer_config(f"{out}/vl_train_mesh", f"{out}/train.jsonl", f"{out}/val.jsonl",
                            mesh=MeshConfig(mesh.data, mesh.model))
    trainer = Trainer(cfg, model=seeded_videollama(cfg), device="cpu")
    trainer.train()
    np.savez(f"{out}/vl_train_leaves_{rank}.npz",
             **{k.replace("/", "|"): p.detach().numpy() for k, p in trainer.trainable.items()
                if not k.startswith("llm/")})


def vl_trainer_config(out, train_ann, val_ann, mesh=None) -> RunConfig:
    return trainer_config(out, train_ann, val_ann, mesh, max_epoch=1).replace(
        model_name="VideoLLaMA", model=vl_config().model)


def seq_layers(out, mesh, rank):
    """The decoder alone (``test_torch_seq_shard.py``): outputs and
    gradients with and without ``seq_shard`` on this mesh's model axis,
    and the S-axis collectives, on a ragged S-token sequence."""
    inputs = np.load(f"{out}/llm_inputs.npz")
    state = torch.load(f"{out}/llm_state.pt", weights_only=True)
    res = {}
    for name, seq in (("base", False), ("sp", True)):
        holder = decoder({"seq_shard": seq})
        holder.load_state_dict(state)
        specs = parallel.shard_module_(holder, mesh)
        names = [n for n, _ in holder.named_parameters() if "lora" in n]
        lora = [p.requires_grad_(True) for n, p in holder.named_parameters() if "lora" in n]
        emb = torch.from_numpy(inputs["emb"])
        s = emb.shape[1]
        mask = torch.ones((s, s), dtype=torch.bool).tril()[None, None]
        pos = torch.arange(s)[None].expand(emb.shape[0], s)
        hidden, _ = holder.llm(emb, mask, pos, return_hidden=True)
        logits = holder.llm.logits(hidden)
        grads = torch.autograd.grad((logits * torch.from_numpy(inputs["probe"])).sum(), lora)
        grads = dict(zip(names, grads))
        partial = [n for n in names if "model" not in specs[n]]
        comm.all_reduce_sum_(grads, partial, mesh.model_group)
        full = {n: parallel.partition.gather_leaf(g, specs[n], mesh).tolist()
                for n, g in grads.items()}
        res[name] = {"logits": logits.tolist(), "grads": full,
                     "sp": holder.llm.seq_parallel(s)}
    res["gates"] = [holder.llm.seq_parallel(n) for n in (1, 3, 4, S)]
    x = torch.arange(2 * S * 3, dtype=torch.float32).reshape(2, S, 3) + rank
    chunk = comm.split_seq(x, mesh.model_group)
    res["chunk"] = chunk.tolist()
    res["gathered"] = comm.gather_seq(chunk, mesh.model_group, S).tolist()
    res["scattered"] = comm.scatter_seq(x, mesh.model_group).tolist()
    json.dump(res, open(f"{out}/seq_layers_{rank}.json", "w"))


SCENARIOS = {f.__name__: f for f in (generate, decoders, loss, train, infer, gather, mesh_errors,
                                     seq_layers, vl_generate, vl_loss, vl_train)}


def main(out, data, model, scenarios):
    torch.set_num_threads(1)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group("gloo", init_method=f"file://{out}/rendezvous", rank=rank,
                            world_size=world)
    try:
        mesh = parallel.make_mesh(MeshConfig(data=data, model=model))
        for name in scenarios:
            SCENARIOS[name](out, mesh, rank)
    finally:
        dist.destroy_process_group()


def run_once(tmp_path_factory, name: str, build):
    """``build(root)`` once per test session, by whichever test worker
    gets there first (the others wait on a file lock, then read what it
    wrote): the ranks' processes are not started again by every worker
    that draws a test of the module.  Returns ``root``."""
    import shutil

    from filelock import FileLock

    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent              # shared by the session's workers
    root = base / name
    with FileLock(str(base / f"{name}.lock")):
        if not (root / "done").exists():
            shutil.rmtree(root, ignore_errors=True)
            root.mkdir()
            build(root)
            (root / "done").touch()
    return root


def launch(out, data, model, scenarios, timeout=240):
    """Run the scenarios on a ``data x model`` mesh of CPU processes;
    raises with a rank's output if one fails."""
    world = data * model
    env = dict(os.environ, WORLD_SIZE=str(world), OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, __file__, str(out), str(data), str(model),
                               *scenarios], env=dict(env, RANK=str(r)), cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode:
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n{text[-4000:]}")


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4:])
