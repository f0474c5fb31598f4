"""Parameter partition rules (flat flax name → per-axis spec), and the
slicing that applies them.

The JAX package's ``parallel/partition.py`` as data: Megatron-style
tensor parallelism of the Llama decoder over ``model`` — column-parallel
q/k/v and gate/up (output features sharded), row-parallel o_proj and
down_proj (input features sharded), one reduction per sublayer — with
the LoRA adapters sharded with their base projection (A replicated and B
like the base output for a column projection; A like the base input and
B replicated for a row projection), the int8, int4 and scale leaves
alike, and the vocabulary of ``lm_head`` and ``embed_tokens`` sharded.
The frozen encoders (:data:`FSDP_PREFIXES`) are ZeRO-3-sharded over
``data`` along their largest evenly tiling dimension.  The first
matching rule wins; anything unmatched is replicated.

A spec is a tuple of axis names (``"data"``, ``"model"``) or None per
dimension, as long as the JAX ``PartitionSpec`` it mirrors;
:func:`partition_spec` is free of process groups, so that a test can
hold it against ``param_shardings`` leaf by leaf.  :func:`shard_params`
slices a full flat tree into this rank's shards and
:func:`gather_params` puts them back together (checkpoints and the param
store hold full leaves).
"""

from __future__ import annotations

import re

import torch

from mraudio_tpu_torch.parallel import comm

_COL = r"(q_proj|k_proj|v_proj|gate_proj|up_proj)"
_ROW = r"(o_proj|down_proj)"

# (regex over the '/'-joined flax path, spec); paths start with the
# top-level component ("llm", "vit", ...).
LLM_RULES: list[tuple[str, tuple]] = [
    # column-parallel projections: out features on "model"
    (rf"llm/.*{_COL}/kernel$", (None, "model")),
    (rf"llm/.*{_COL}/w_int8$", (None, "model")),
    # int4 weights are (groups, group / 2, out); their scale (groups, out)
    (rf"llm/.*{_COL}/w_int4$", (None, None, "model")),
    (rf"llm/.*{_COL}/w_int4_scale$", (None, "model")),
    (rf"llm/.*{_COL}/scale$", ("model",)),
    (rf"llm/.*{_COL}/lora_b$", (None, "model")),
    # row-parallel projections: in features on "model"
    (rf"llm/.*{_ROW}/kernel$", ("model", None)),
    (rf"llm/.*{_ROW}/w_int8$", ("model", None)),
    (rf"llm/.*{_ROW}/w_int4$", ("model", None, None)),
    (rf"llm/.*{_ROW}/w_int4_scale$", ("model", None)),
    (rf"llm/.*{_ROW}/scale$", ()),
    (rf"llm/.*{_ROW}/lora_a$", ("model", None)),
    # lm_head and the embedding: vocab-sharded (an uneven vocab
    # replicates through the shape-aware fix-up)
    (r"llm/lm_head/kernel$", (None, "model")),
    (r"llm/lm_head/w_int8$", (None, "model")),
    (r"llm/lm_head/scale$", ("model",)),
    (r"llm/embed_tokens/embedding$", ("model", None)),
]

# The frozen encoder towers, ZeRO-3-sharded over "data" (the small
# per-modality ln/proj/query-token leaves stay replicated; VideoLLaMA's
# trainable "audio_proj" must).
FSDP_PREFIXES = ("vit/", "beats/", "video_qformer/", "audio_qformer/")


def fsdp_spec(shape: tuple, data_size: int) -> tuple | None:
    """Largest-dimension FSDP spec for a frozen leaf, or None when no
    dimension tiles evenly over the data axis (the leaf replicates)."""
    if data_size <= 1 or not len(shape):
        return None
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[i] % data_size == 0 and shape[i] >= data_size:
            axes = [None] * len(shape)
            axes[i] = "data"
            return tuple(axes)
    return None


def _match(name: str, rules) -> tuple:
    for pattern, spec in rules:
        if re.search(pattern, name):
            return spec
    return ()


def partition_spec(name: str, shape: tuple, mesh_shape: dict, rules=None,
                   fsdp_encoders: bool = True) -> tuple:
    """The spec of the leaf ``name`` of ``shape`` on a mesh of
    ``mesh_shape`` (``{"data": d, "model": m}``), as the JAX package's
    ``param_shardings`` computes it: a rule axis that does not tile its
    dimension evenly is dropped (replicated), and under ``scan_layers``
    (``.../layers/...`` leaves with a leading layer axis) the rule's axes
    shift right by one."""
    rules = LLM_RULES if rules is None else rules
    shape = tuple(shape)
    data_size = mesh_shape.get("data", 1) if fsdp_encoders else 1
    spec = _match(name, rules)
    if not len(spec) and data_size > 1 and name.startswith(FSDP_PREFIXES):
        fs = fsdp_spec(shape, data_size)
        if fs is not None:
            return fs
    if "/layers/" in name and len(spec):
        spec = (None,) + spec
    spec = spec[:len(shape)]
    return tuple(axis if axis is None or shape[i] % mesh_shape[axis] == 0 else None
                 for i, axis in enumerate(spec))


def param_specs(flat: dict, mesh_shape: dict, rules=None, fsdp_encoders: bool = True) -> dict:
    """``{name: spec}`` over a flat ``{name: tensor}`` dict."""
    return {k: partition_spec(k, tuple(v.shape), mesh_shape, rules, fsdp_encoders)
            for k, v in flat.items()}


def local_slice(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's shard of the full tensor ``t`` under ``spec``."""
    for dim, axis in enumerate(spec):
        if axis is None or mesh.size(axis) == 1:
            continue
        n = t.shape[dim] // mesh.size(axis)
        t = t.narrow(dim, mesh.index(axis) * n, n)
    return t.contiguous()


def gather_leaf(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The full tensor from every rank's shard ``t`` under ``spec`` (a
    collective: every rank of the sharded axes calls it)."""
    for dim, axis in enumerate(spec):
        if axis is not None and mesh.size(axis) > 1:
            t = comm.all_gather_cat(t, dim, mesh.group(axis))
    return t


def shard_params(flat: dict, mesh, specs: dict | None = None) -> dict:
    """A full flat tree → this rank's shards."""
    specs = param_specs(flat, mesh.shape) if specs is None else specs
    return {k: local_slice(v, specs[k], mesh) for k, v in flat.items()}


def gather_params(flat: dict, mesh, specs: dict) -> dict:
    """Inverse of :func:`shard_params`: the full leaves, on every rank."""
    return {k: gather_leaf(v, specs[k], mesh) for k, v in flat.items()}


# ---------------------------------------------------------------------------
# a module's parameters


def _flax_name(torch_name: str) -> str:
    from mraudio_tpu_torch.models.convert_jax import _flax_scopes

    return "/".join(_flax_scopes(torch_name.split(".")))


def module_specs(module, mesh_shape: dict) -> dict:
    """``{port parameter name: spec over the stored tensor}`` of
    ``module`` on a mesh of ``mesh_shape``.  The decoder's leaves are
    stored in the flax layout and take :func:`partition_spec` of their
    flax name; a kernel stored int8 (``models/quant_tree.py``, its values
    and scale under ``parametrizations``) shards its values as the kernel
    and its scale as the kernel's output axis.  The encoder towers'
    leaves, stored in the port's layout, take :func:`fsdp_spec` of their
    own shape (they are put back together wherever they are read, so
    only this process sees the layout)."""
    specs = {}
    for name, p in module.named_parameters():
        flax = _flax_name(name)
        if flax.startswith(FSDP_PREFIXES):
            specs[name] = fsdp_spec(tuple(p.shape), mesh_shape.get("data", 1)) or ()
            continue
        parts = flax.split("/")
        if "parametrizations" in parts:
            i = parts.index("parametrizations")
            base = "/".join(parts[:i] + [parts[i + 1]])
            owner = module.get_submodule(".".join(name.split(".")[:-3]))
            kernel = partition_spec(base, tuple(owner.parametrizations[parts[i + 1]]
                                                .original0.shape), mesh_shape)
            specs[name] = kernel if parts[-1] == "original0" else (
                (kernel[-1],) if len(kernel) == 2 else ())
            continue
        specs[name] = partition_spec(flax, tuple(p.shape), mesh_shape)
    return specs


def _sharded(spec: tuple, axis: str, mesh) -> bool:
    return axis in spec and mesh.size(axis) > 1


@torch.no_grad()
def shard_module_(module, mesh) -> dict:
    """Slice ``module``'s full parameters into this rank's shards in place
    and switch its decoder to tensor parallelism (``models/llama.py``)
    and its encoder towers to gather-at-use; returns :func:`module_specs`.
    A decoder whose heads or MLP width do not tile the model axis
    raises, and so does one with latent attention or routed experts on a
    model axis (the JAX package would replicate those leaves; the port's
    explicit collectives need every block sharded alike)."""
    from mraudio_tpu_torch.models.llama import LlamaAttention, LlamaLinear, LlamaMlp, LlamaModel

    if mesh.model > 1 and any(isinstance(m, LlamaModel) and (
            m.cfg.attention_kind != "gqa" or m.cfg.n_routed_experts) for m in module.modules()):
        raise NotImplementedError("mesh.model > 1 is not supported with latent attention or "
                                  "routed experts: neither is split over a model axis")
    specs = module_specs(module, mesh.shape)
    params = dict(module.named_parameters())
    for name, p in params.items():
        if any(a is not None and mesh.size(a) > 1 for a in specs[name]):
            p.data = local_slice(p.data, specs[name], mesh)
    module.mesh = mesh
    group = mesh.model_group
    for prefix, mod in module.named_modules():
        dotted = prefix + "." if prefix else ""
        if isinstance(mod, LlamaModel):
            mod.tp_group = group
            mod.vocab_sharded = _sharded(specs[dotted + "embed_tokens.embedding"], "model", mesh)
        elif isinstance(mod, (LlamaAttention, LlamaMlp)) and group is not None:
            mod.tp_group = group
            if isinstance(mod, LlamaAttention):
                m = mesh.model
                if mod.heads % m or mod.kv_heads % m:
                    raise ValueError(f"{prefix}: {mod.heads} heads and {mod.kv_heads} KV "
                                     f"heads do not tile a model axis of {m}")
                mod.heads, mod.kv_heads = mod.heads // m, mod.kv_heads // m
        elif isinstance(mod, LlamaLinear):
            mod.dropout_part = (mesh.data_index, mesh.data, 0, mod.in_features)
            weight = next(n for n in (dotted + w for w in (
                "kernel", "w_int8", "w_int4", "parametrizations.kernel.original0"))
                if n in specs)
            spec = specs[weight]
            if not _sharded(spec, "model", mesh):
                if group is not None and not prefix.endswith("lm_head"):
                    raise ValueError(f"{prefix}: {tuple(params[weight].shape)} does not "
                                     f"tile a model axis of {mesh.model}")
                continue
            row = spec[0] == "model"
            mod.tp_mode, mod.tp_group = ("row" if row else "column"), group
            if row:
                if mod.bias is not None:
                    raise ValueError(f"{prefix}: a row-parallel projection with a bias")
                width = mod.local_dims()[0]
                mod.dropout_part = (mesh.data_index, mesh.data, mesh.model_index * width,
                                    mod.in_features)
            elif mod.bias is not None:
                mod.bias.data = local_slice(mod.bias.data, ("model",), mesh)
    _fsdp_hooks(module, specs, params, mesh)
    return specs


def _fsdp_hooks(module, specs: dict, params: dict, mesh) -> None:
    """Each encoder tower with data-sharded leaves gathers them when it
    is called and drops the gathered copies when it returns."""
    group = mesh.data_group
    if group is None:
        return
    towers = {}
    for name, spec in specs.items():
        if "data" in spec:
            towers.setdefault(name.split(".")[0], []).append(
                (params[name], spec.index("data"), params[name].data))
    for tower, leaves in towers.items():
        def gather(mod, args, leaves=leaves):
            for p, dim, local in leaves:
                p.data = comm.all_gather_cat(local, dim, group)

        def release(mod, args, out, leaves=leaves):
            for p, _, local in leaves:
                p.data = local

        getattr(module, tower).register_forward_pre_hook(gather)
        getattr(module, tower).register_forward_hook(release)
