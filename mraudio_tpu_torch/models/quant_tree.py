"""Int8 storage for frozen float kernels (the JAX package's
``models/quant_tree.py``): ``train.quant_frozen="int8"`` and the evaluate
and serve CLIs' ``--quant-encoders``.

An eligible ``kernel`` — a float kernel with at least :data:`MIN_DIM0`
rows on its input axis and :data:`MIN_SIZE` elements, not under
``lm_head`` — becomes an int8 tensor and an f32 per-column scale (absmax
over the input axis / 127, the bitsandbytes convention), stored under
the JAX keys ``(..., "kernel", "int8")`` and ``(..., "kernel",
"scale")``.  Eligibility and quantization read the flax layout (a
``DenseGeneral`` kernel (in, heads, head_dim) or (heads, head_dim, out),
BEATs' ``pos_conv`` (k, in/groups, out)), so the bits are the JAX
package's.

The flat-dict functions mirror the JAX ones over ``{path tuple: tensor}``
dicts in the flax layout.  :func:`quantize_module_` applies the same
transform to a module in place: each eligible kernel's parameter is
replaced by its int8 values and scale, held by a parametrization
(``torch.nn.utils.parametrize``) that dequantizes at every read, as
``(q.float() * scale).to(bfloat16)`` (the JAX order) viewed in the
port's layout — so a module reads its kernel as before (the encoders of
``XInstructBLIP._encode_modality_tokens`` included) and no bf16 copy
stays resident.  This is a memory lever and an approximation: the
reference keeps its encoders in fp16.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn.utils import parametrize

# A quantized leaf (..., "kernel") is stored as two keys (..., "kernel",
# QKEY) and (..., "kernel", SKEY); no parameter path passes through a
# "kernel" component otherwise, so the pairing is unambiguous.
QKEY = "int8"
SKEY = "scale"

# Eligible leaves: float kernels with a real input axis to amortize the
# f32 scale over, and big enough to matter.
MIN_DIM0 = 16
MIN_SIZE = 65536


def _eligible(path: tuple, leaf) -> bool:
    if path[-1] != "kernel" or any(p == "lm_head" for p in path):
        return False
    if not leaf.is_floating_point():
        return False
    return leaf.ndim >= 2 and leaf.shape[0] >= MIN_DIM0 and leaf.numel() >= MIN_SIZE


def _quantize_one(w: torch.Tensor):
    wf = w.float()
    absmax = wf.abs().amax(dim=0)
    # absmax / 127 as the JAX package's jitted quantizer computes it: XLA
    # turns the division by a constant into a product with its f32
    # reciprocal, which rounds differently for a few percent of columns
    scale = torch.where(absmax == 0, 1.0, absmax * (1.0 / 127.0))
    return torch.round(wf / scale).to(torch.int8), scale


def _dequantize_one(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def quantize_frozen(flat: dict) -> dict:
    """``{path tuple: tensor}`` → the same dict with every eligible kernel
    replaced by its int8 + scale pair."""
    out = {}
    for k, v in flat.items():
        if not _eligible(k, v):
            out[k] = v
            continue
        out[k + (QKEY,)], out[k + (SKEY,)] = _quantize_one(v)
    return out


def dequantize_frozen(flat: dict, dtype=torch.bfloat16) -> dict:
    """Inverse of :func:`quantize_frozen` key-wise; a dict with no
    quantized keys comes back unchanged."""
    out = {}
    for k, v in flat.items():
        if len(k) >= 2 and k[-2] == "kernel" and k[-1] == QKEY:
            out[k[:-1]] = _dequantize_one(v, flat[k[:-1] + (SKEY,)], dtype)
        elif not (len(k) >= 2 and k[-2] == "kernel" and k[-1] == SKEY):
            out[k] = v
    return out


def _flatten(tree: dict, prefix: tuple = ()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return tree


def quantize_subtrees(params: dict, keys) -> dict:
    """Nested-tree front end: quantize the eligible kernels of
    ``params[k]`` for every ``k`` in ``keys`` (the frozen encoder
    components, ``XInstructBLIP.ENCODER_PARAM_KEYS``)."""
    out = dict(params)
    for k in keys:
        sub = out.get(k)
        if isinstance(sub, dict):
            out[k] = _unflatten(quantize_frozen(_flatten(sub)))
    return out


def dequantize_subtrees(params: dict, keys, dtype=torch.bfloat16) -> dict:
    """Inverse of :func:`quantize_subtrees`; subtrees with no quantized
    leaf pass through untouched."""
    out = dict(params)
    for k in keys:
        sub = out.get(k)
        if not isinstance(sub, dict):
            continue
        flat = _flatten(sub)
        if any(p[-1] == QKEY for p in flat):
            out[k] = _unflatten(dequantize_frozen(flat, dtype))
    return out


def quantized_bytes_saved(flat: dict) -> int:
    """Bytes saved against bf16 storage of the quantized leaves."""
    saved = 0
    for k, v in flat.items():
        if len(k) >= 2 and k[-2] == "kernel" and k[-1] == QKEY:
            saved += v.numel() - flat[k[:-1] + (SKEY,)].numel() * 4
    return saved


class Int8Kernel(nn.Module):
    """Parametrization of a kernel held as int8 values and an f32 scale
    in the flax layout: every read dequantizes, ``(q.float() * scale)``
    cast to ``dtype``, and views the result in the port's layout."""

    def __init__(self, port_shape, flax_shape, permute: bool, dtype=torch.bfloat16):
        super().__init__()
        self.port_shape, self.flax_shape = tuple(port_shape), tuple(flax_shape)
        self.permute, self.dtype = permute, dtype

    def forward(self, q, scale):
        w = _dequantize_one(q, scale, self.dtype)
        return w.permute(2, 1, 0) if self.permute else w.reshape(self.port_shape)

    def right_inverse(self, w):
        flax = w.permute(2, 1, 0) if self.permute else w.reshape(self.flax_shape)
        return _quantize_one(flax)


@torch.no_grad()
def quantize_module_(module: nn.Module, keys=None, skip=(), dtype=torch.bfloat16) -> int:
    """Quantize ``module``'s eligible kernels in place (see the module
    docstring): those under the top-level scopes ``keys`` (every scope
    with ``keys=None``), minus the flax names in ``skip`` (trainable
    leaves).  Returns :func:`quantized_bytes_saved` of what it
    quantized."""
    from mraudio_tpu_torch.models.convert_jax import flax_params, torch_name

    saved = 0
    for name, flax in flax_params(module, stacked=False).items():
        path = tuple(name.split("/"))
        if (keys is not None and path[0] not in keys) or name in skip or not _eligible(path, flax):
            continue
        owner, leaf = torch_name(path).rsplit(".", 1)
        mod = module.get_submodule(owner)
        p = getattr(mod, leaf)
        kernel = Int8Kernel(p.shape, flax.shape, permute=owner.endswith("pos_conv"), dtype=dtype)
        parametrize.register_parametrization(mod, leaf, kernel, unsafe=True)
        q = getattr(mod.parametrizations, leaf).original0
        saved += q.numel() - getattr(mod.parametrizations, leaf).original1.numel() * 4
    return saved
