"""Checkpoints of the trainable leaves, in the port's store format.

As in the JAX package, a checkpoint holds only what trains (the
reference deletes its frozen entries before saving) plus the optimizer
state and the epoch; resume restores all three.  The file is one
``torch.save`` of ``{"model": {flat flax name: tensor}, "opt_state":
{name: tensor}, "epoch": int}`` (the flat names of ``cli/convert.py``'s
param store), read with ``torch.load(weights_only=True)``.  Each
checkpoint has a ``<path>.meta.json`` sidecar, which the trainer writes
(the exact step position for a mid-epoch resume).  The JAX package's
orbax directories are not read (ROADMAP.md C.3).
"""

from __future__ import annotations

import os

import torch
from torch import nn

META_SUFFIX = ".meta.json"


def resolve_path(path: str) -> str:
    """A checkpoint's path: a ``*.meta.json`` sidecar (what a glob for the
    latest ``checkpoint_*`` picks, as it sorts after the checkpoint)
    names the checkpoint it annotates."""
    if path.endswith(META_SUFFIX):
        path = path[: -len(META_SUFFIX)]
    return os.path.abspath(path)


def save_checkpoint(output_dir: str, name: str, trainable_flat: dict, opt_state: dict,
                    epoch: int) -> str:
    """Write ``{output_dir}/checkpoint_{name}`` (name: 'best', 'preempt' or
    the epoch) on the host, replacing any earlier one in one rename."""
    path = os.path.abspath(os.path.join(output_dir, f"checkpoint_{name}"))
    os.makedirs(output_dir, exist_ok=True)
    payload = {
        "model": {k: v.detach().cpu().contiguous() for k, v in trainable_flat.items()},
        "opt_state": {k: v.detach().cpu().contiguous() for k, v in opt_state.items()},
        "epoch": int(epoch),
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str) -> dict:
    """``{"model": {flat name: tensor}, "opt_state": {...}, "epoch": int}``
    of a checkpoint, on the host."""
    return torch.load(resolve_path(path), map_location="cpu", weights_only=True)


@torch.no_grad()
def apply_trainable(model: nn.Module, trainable_flat: dict) -> nn.Module:
    """Overlay a checkpoint's trainable leaves onto ``model``'s parameters
    (each copied in the leaf's own dtype); a name the model lacks
    raises.  Stacked ``scan_layers`` leaves are split over the layers."""
    from mraudio_tpu_torch.models.convert_jax import torch_name, unstack_layers

    params = dict(model.named_parameters())
    for k, v in unstack_layers(trainable_flat).items():
        name = torch_name(tuple(k.split("/")))
        if name not in params:
            raise KeyError(f"checkpoint param {k} not in model")
        p = params[name]
        p.data = v.reshape(p.shape).to(p.device, copy=True).contiguous()
    return model
