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
  as they are, in the dtypes given (f32, bf16, int8).

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

_SCOPE_RE = re.compile(r"^(layer|block|gate)_(\d+)$")
_SCOPE_NAMES = {"layer": "layers", "block": "blocks", "gate": "gates"}
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


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: device_get arrays are read-only
    if a.dtype.name == "bfloat16":  # ml_dtypes.bfloat16 from jax.device_get
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@torch.no_grad()
def load_jax_params_(module: nn.Module, tree: dict) -> nn.Module:
    """Copy a JAX parameter tree (nested dicts of numpy arrays) into
    ``module``; every parameter must be covered exactly once."""
    params = dict(module.named_parameters())
    seen = set()
    for path, arr in _flatten(tree):
        name = torch_name(path)
        if name not in params:
            raise KeyError(f"JAX parameter {'/'.join(path)} has no port counterpart {name!r}")
        a = np.asarray(arr)
        if name.endswith("pos_conv.kernel"):
            a = a.transpose(2, 1, 0)
        p = params[name]
        params[name].data = _to_tensor(a.reshape(p.shape)).to(p.device)
        seen.add(name)
    missing = sorted(set(params) - seen)
    if missing:
        raise KeyError(f"port parameters missing from the JAX tree: {missing[:8]}")
    return module


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
