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
* ``Embed.embedding``, ``w_int8``/``scale``, ``lora_a``/``lora_b`` copy
  as they are, in the dtypes given (f32, f16, bf16, int8).

:func:`overlay_jax_params_` copies a tree that covers part of the module
(a converted checkpoint, ``models/convert_weights.py``), and
:func:`flax_params` gives the inverse: every parameter under its
``'/'``-joined flax path in the flax layout, the flat names of the JAX
param store (``cli/convert.py`` writes the port's store with them).

:func:`init_random_` fills every parameter from a ``torch.Generator``
on the parameters' device, at any width.  Its int8 weights are seeded
uniform values in [-127, 127] with per-column scales that give an
effective N(0, 0.02)-sized weight — never the all-zero int8 weights of
the flax init, which would hide a broken GEMV.
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


@torch.no_grad()
def overlay_jax_params_(module: nn.Module, tree: dict) -> set:
    """Copy every leaf of a JAX parameter tree (nested dicts of numpy
    arrays or tensors) into ``module``, each in the leaf's own dtype; the
    tree may cover part of the module.  Returns the port names covered."""
    params = dict(module.named_parameters())
    seen = set()
    for path, arr in _flatten(tree):
        name = torch_name(path)
        if name not in params:
            raise KeyError(f"JAX parameter {'/'.join(path)} has no port counterpart {name!r}")
        t = _to_tensor(arr)
        if name.endswith("pos_conv.kernel"):
            t = t.permute(2, 1, 0)
        p = params[name]
        # a tensor leaf (the param store's) is copied, never shared
        p.data = t.reshape(p.shape).to(p.device, copy=isinstance(arr, torch.Tensor)).contiguous()
        seen.add(name)
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


def flax_params(module: nn.Module) -> dict:
    """``{'/'-joined flax path: tensor}`` for every parameter of
    ``module``, in the flax layout (the inverse of :func:`torch_name` and
    of the reshapes :func:`overlay_jax_params_` makes): views of the
    parameters where a reshape suffices."""
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
    for name, p in params.items():
        parts = name.split(".")
        leaf, scope = parts[-1], parts[:-1]
        in_norm = any(s in n for n in scope for s in _NORM_SCOPES)
        if p.dtype == torch.int8:
            p.copy_(torch.randint(-127, 128, p.shape, generator=gen, device=device,
                                  dtype=torch.int8))
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
