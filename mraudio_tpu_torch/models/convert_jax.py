"""Weights for the port: loading a JAX-package parameter tree, and the
port's own seeded random init.

:func:`load_jax_params_` takes the JAX package's tree as nested dicts of
numpy arrays (what ``jax.device_get`` returns) and copies it into the
port's modules, which mirror the flax scope names:

* ``layer_i`` / ``block_i`` / ``gate_i`` scopes → ``layers.i`` /
  ``blocks.i`` / ``gates.i``; flax's ``LayerNorm_0`` scope is dropped;
* ``Dense`` kernels are (in, out) on both sides; ``DenseGeneral``
  kernels (in, heads, hd) / (heads, hd, out) and biases (heads, hd)
  flatten to the port's 2-D / 1-D parameters;
* the BEATs ``pos_conv`` kernel (k, in/groups, out) becomes torch's
  (out, in/groups, k);
* ``Embed.embedding``, ``w_int8``/``scale``, ``w_int4``/``w_int4_scale``,
  ``lora_a``/``lora_b`` and the saliency head's ``fc1``/``fc2`` copy as
  they are, in the dtypes given (f32, f16, bf16, int8, uint8), both ways;
* the ``scan_layers`` layout: a decoder whose config sets it is stored
  as ``llm/layers/...`` leaves with a leading (num_layers,) axis (the
  JAX package's ``nn.scan`` tree) where the modules keep one block per
  layer; :func:`flax_params` stacks, :func:`overlay_jax_params_` takes
  either layout and unstacks, and :func:`stack_layers` /
  :func:`unstack_layers` convert flat name dicts (the trainer's
  checkpoints).

:func:`overlay_jax_params_` copies a tree that covers part of the module
(a converted checkpoint, ``models/convert_weights.py``), and
:func:`flax_params` gives the inverse: every parameter under its
``'/'``-joined flax path in the flax layout, the flat names of the JAX
param store (``cli/convert.py`` writes the port's store with them).

:func:`init_random_` fills every parameter from a ``torch.Generator``
on the parameters' device, at any width.  Its int8 weights are seeded
uniform values in [-127, 127] (int4: uniform bytes, i.e. nibbles in
[-8, 7]) with positive scales that give an effective N(0, 0.02)-sized
weight — never the all-zero quantized weights of the flax init, which
would hide a broken GEMV.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from mraudio_tpu_torch.models.layers import Attention, LayerNormFp32

_SCOPE_RE = re.compile(r"^(layer|block|gate)_(\d+)$")
_SCOPE_NAMES = {"layer": "layers", "block": "blocks", "gate": "gates"}
_FLAX_SCOPES = {v: k for k, v in _SCOPE_NAMES.items()}
_NORM_SCOPES = ("norm", "ln")


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (str(k),))
    else:
        yield prefix, tree


def nested(flat: dict) -> dict:
    """``{'/'-joined flax path: leaf}`` → the nested tree the loaders
    take."""
    tree: dict = {}
    for name, leaf in flat.items():
        *scopes, last = name.split("/")
        node = tree
        for s in scopes:
            node = node.setdefault(s, {})
        node[last] = leaf
    return tree


def torch_name(path: tuple) -> str:
    """Dotted port parameter name of a flax parameter path."""
    parts = []
    for p in path:
        if p == "LayerNorm_0":
            continue
        m = _SCOPE_RE.match(p)
        parts.append(f"{_SCOPE_NAMES[m[1]]}.{m[2]}" if m else p)
    return ".".join(parts)


def _to_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = np.array(a, order="C")  # a writable copy: device_get arrays are read-only
    if a.dtype.name == "bfloat16":  # ml_dtypes.bfloat16 from jax.device_get
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _stacked_names(path: tuple, params: dict):
    """The per-layer port names of a ``scan_layers`` leaf (``.../layers/
    <rest>``, no layer index after ``layers``), or None when ``path`` is
    not one."""
    for j, p in enumerate(path[:-1]):
        if p == "layers":
            head = torch_name(path[:j])
            rest = torch_name(path[j + 1:])
            first = ".".join(filter(None, (head, "layers", "0", rest)))
            if first in params:
                return lambda i: ".".join(filter(None, (head, "layers", str(i), rest)))
    return None


@torch.no_grad()
def overlay_jax_params_(module: nn.Module, tree: dict) -> set:
    """Copy every leaf of a JAX parameter tree (nested dicts of numpy
    arrays or tensors) into ``module``, each in the leaf's own dtype; the
    tree may cover part of the module, and may hold a decoder in either
    layout (a stacked ``layers`` leaf is split over the layers).  Returns
    the port names covered."""
    params = dict(module.named_parameters())
    seen = set()

    def put(name, t, copy):
        p = params[name]
        # a tensor leaf (the param store's) is copied, never shared
        p.data = t.reshape(p.shape).to(p.device, copy=copy).contiguous()
        seen.add(name)

    for path, arr in _flatten(tree):
        name = torch_name(path)
        t = _to_tensor(arr)
        if name not in params:
            per_layer = _stacked_names(path, params)
            if per_layer is None:
                raise KeyError(f"JAX parameter {'/'.join(path)} has no port counterpart "
                               f"{name!r}")
            for i in range(t.shape[0]):
                put(per_layer(i), t[i], copy=True)
            continue
        if name.endswith("pos_conv.kernel"):
            t = t.permute(2, 1, 0)
        put(name, t, copy=isinstance(arr, torch.Tensor))
    return seen


def load_jax_params_(module: nn.Module, tree: dict) -> nn.Module:
    """Copy a JAX parameter tree into ``module``; every parameter must be
    covered exactly once."""
    seen = overlay_jax_params_(module, tree)
    missing = sorted(set(dict(module.named_parameters())) - seen)
    if missing:
        raise KeyError(f"port parameters missing from the JAX tree: {missing[:8]}")
    return module


def _flax_scopes(parts: list) -> list:
    out, i = [], 0
    while i < len(parts):
        if parts[i] in _FLAX_SCOPES and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(f"{_FLAX_SCOPES[parts[i]]}_{parts[i + 1]}")
            i += 2
        else:
            out.append(parts[i])
            i += 1
    return out


def flax_params(module: nn.Module, stacked: bool | None = None) -> dict:
    """``{'/'-joined flax path: tensor}`` for every parameter of
    ``module``, in the flax layout (the inverse of :func:`torch_name` and
    of the reshapes :func:`overlay_jax_params_` makes): views of the
    parameters where a reshape suffices.  A decoder whose config sets
    ``scan_layers`` (or every decoder, with ``stacked=True``; none, with
    ``stacked=False``) gives its layers as stacked ``layers`` leaves
    (copies)."""
    out = {}
    for mod_name, mod in module.named_modules():
        parts = mod_name.split(".") if mod_name else []
        parent = module.get_submodule(".".join(parts[:-1])) if parts else None
        for leaf, p in mod.named_parameters(recurse=False):
            path = _flax_scopes(parts) + (["LayerNorm_0"] if isinstance(mod, LayerNormFp32)
                                          else []) + [leaf]
            t = p.detach()
            if isinstance(parent, Attention):          # flax DenseGeneral layouts
                h, hd = parent.num_heads, parent.head_dim
                if parts[-1] == "out":
                    t = t.reshape(h, hd, -1) if leaf == "kernel" else t
                else:
                    t = t.reshape(-1, h, hd) if leaf == "kernel" else t.reshape(h, hd)
            elif parts and parts[-1] == "pos_conv" and leaf == "kernel":
                t = t.permute(2, 1, 0)
            out["/".join(path)] = t
    if stacked is False:
        return out
    from mraudio_tpu_torch.models.llama import LlamaModel

    for mod_name, mod in module.named_modules():
        if isinstance(mod, LlamaModel) and (stacked or mod.cfg.scan_layers):
            prefix = "/".join(_flax_scopes(mod_name.split("."))) if mod_name else ""
            out = stack_layers(out, prefix, mod.cfg.num_layers)
    return out


def stack_layers(flat: dict, prefix: str, num_layers: int) -> dict:
    """A flat ``{flax name: tensor}`` dict with the decoder at ``prefix``
    (``"llm"``, or ``""`` for a bare decoder) in the per-layer layout →
    the ``scan_layers`` layout: every ``{prefix}/layer_i/<rest>`` leaf
    stacked into ``{prefix}/layers/<rest>``, in layer order."""
    head = f"{prefix}/" if prefix else ""
    per_layer = re.compile(rf"^{re.escape(head)}layer_(\d+)/(.+)$")
    out, groups = {}, {}
    for k, v in flat.items():
        m = per_layer.match(k)
        if m:
            groups.setdefault(m[2], {})[int(m[1])] = v
        else:
            out[k] = v
    for rest, layers in groups.items():
        out[f"{head}layers/{rest}"] = torch.stack([layers[i] for i in range(num_layers)])
    return out


def unstack_layers(flat: dict) -> dict:
    """Inverse of :func:`stack_layers` over a flat ``{flax name: tensor}``
    dict: every ``.../layers/<rest>`` leaf split into
    ``.../layer_i/<rest>``; a dict with no stacked leaf comes back as it
    is."""
    out = {}
    for k, v in flat.items():
        parts = k.split("/")
        j = next((j for j, p in enumerate(parts[:-1]) if p == "layers"), None)
        if j is None:
            out[k] = v
            continue
        for i in range(v.shape[0]):
            out["/".join(parts[:j] + [f"layer_{i}"] + parts[j + 1:])] = v[i]
    return out


@torch.no_grad()
def init_random_(module: nn.Module, seed: int = 0, std: float = 0.02) -> nn.Module:
    """Seeded random init of every parameter of ``module`` on its device:
    norm scales 1 and biases 0, LoRA ``lora_b`` 0 and ``lora_a``
    N(0, 1/r), int8 weights uniform in [-127, 127] with scales for an
    effective std of ``std``, everything else N(0, std)."""
    params = dict(module.named_parameters())
    if not params:
        return module
    device = next(iter(params.values())).device
    gen = torch.Generator(device=device).manual_seed(seed)
    int8_std = float(np.sqrt((255.0 ** 2 - 1.0) / 12.0))  # uniform ints on [-127, 127]
    int4_std = float(np.sqrt((16.0 ** 2 - 1.0) / 12.0))   # uniform nibbles on [-8, 7]
    for name, p in params.items():
        parts = name.split(".")
        leaf, scope = parts[-1], parts[:-1]
        in_norm = any(s in n for n in scope for s in _NORM_SCOPES)
        if p.dtype == torch.int8:
            p.copy_(torch.randint(-127, 128, p.shape, generator=gen, device=device,
                                  dtype=torch.int8))
        elif p.dtype == torch.uint8:
            p.copy_(torch.randint(0, 256, p.shape, generator=gen, device=device,
                                  dtype=torch.uint8))
        elif leaf == "w_int4_scale":
            p.fill_(std / int4_std)
        elif leaf == "scale" and name[: -len("scale")] + "w_int8" in params:
            p.fill_(std / int8_std)
        elif leaf == "scale" or leaf == "grep_a":
            p.fill_(1.0)
        elif leaf == "bias" or leaf == "lora_b":
            p.zero_()
        elif leaf == "lora_a":
            p.copy_(torch.randn(p.shape, generator=gen, device=device) / p.shape[-1])
        elif in_norm:
            raise ValueError(f"unexpected norm parameter {name}")
        else:
            p.copy_(torch.randn(p.shape, generator=gen, device=device) * std)
    return module
