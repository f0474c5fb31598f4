"""Seeded weights, made on the device in a few large calls.

A *spec* is the sorted list of ``(name, shape, dtype)`` of the parameters
a model serves with.  :func:`fill_` writes values into tensors of that
spec from ``--seed`` alone: one stream of normal values for every float
leaf and one of integers per integer dtype, each drawn by a
``torch.Generator`` on the card in calls of up to :data:`CHUNK` elements,
then shifted and scaled per leaf by the rule below.  The same seed and
spec give the same bits, so the benchmark fills the program's parameters
once and, after the window, makes a second copy for the plain reference
without keeping the first.

Rules (by the leaf's name): int8 values uniform in [-127, 127] with a
per-output-channel f32 ``scale`` of 0.02/73.3 x U(0.5, 1.5) (an effective
std of about 0.02); uint8 uniform bytes; norm scales 1 + N(0, 0.1);
biases N(0, 0.02); LoRA A N(0, 1/r), LoRA B N(0, 0.01) (non-zero, so the
adapters' arithmetic is on the path); every other float N(0, 0.02).
"""

from __future__ import annotations

import numpy as np
import torch

CHUNK = 1 << 27
INT8_STD = float(np.sqrt((255.0 ** 2 - 1.0) / 12.0))   # uniform ints on [-127, 127]
_NORM_SCOPES = ("norm", "ln")


def spec_of(module) -> list:
    """``(name, shape, dtype)`` of every parameter of ``module``, sorted."""
    return sorted((n, tuple(p.shape), p.dtype) for n, p in module.named_parameters())


def _stream_seed(seed: int, stream: int) -> int:
    state = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), stream]).generate_state(1, np.uint64)
    return int(state[0]) & (2 ** 63 - 1)


def _float_rule(name: str, names: set) -> tuple:
    """(kind, mean, std) of a float leaf; kind 'uniform' draws U(0, 1)."""
    parts = name.split(".")
    leaf, scope = parts[-1], parts[:-1]
    in_norm = any(s in p for p in scope for s in _NORM_SCOPES)
    if leaf == "scale" and name[: -len("scale")] + "w_int8" in names:
        return "uniform", 0.5 * 0.02 / INT8_STD, 0.02 / INT8_STD     # base + U(0,1) * span
    if leaf in ("scale", "grep_a") or (in_norm and leaf != "bias"):
        return "normal", 1.0, 0.1
    if leaf == "bias":
        return "normal", 0.0, 0.02
    if leaf == "lora_a":
        return "normal", 0.0, None       # 1 / rank, from the shape
    if leaf == "lora_b":
        return "normal", 0.0, 0.01
    return "normal", 0.0, 0.02


def _batches(leaves: list):
    """Consecutive groups of leaves of about CHUNK elements (a larger leaf
    alone)."""
    group, total = [], 0
    for leaf in leaves:
        n = leaf[1].numel()
        if group and total + n > CHUNK:
            yield group, total
            group, total = [], 0
        group.append(leaf)
        total += n
    if group:
        yield group, total


@torch.no_grad()
def fill_(tensors: dict, seed: int) -> dict:
    """Fill ``{name: tensor}`` (all on one device) from ``seed``; returns it."""
    names = set(tensors)
    items = sorted(tensors.items())
    device = items[0][1].device
    floats = [(n, t) for n, t in items if t.is_floating_point()]
    ints = {dt: [(n, t) for n, t in items if t.dtype == dt] for dt in (torch.int8, torch.uint8)}
    odd = [n for n, t in items if not t.is_floating_point() and t.dtype not in ints]
    if odd:
        raise ValueError(f"no rule for the dtypes of {odd[:4]}")

    gen = torch.Generator(device=device).manual_seed(_stream_seed(seed, 0))
    normal = torch.Generator(device=device).manual_seed(_stream_seed(seed, 1))
    for group, total in _batches(floats):
        u = torch.rand(total, generator=gen, device=device)
        z = torch.randn(total, generator=normal, device=device)
        off = 0
        for name, t in group:
            n = t.numel()
            kind, mean, std = _float_rule(name, names)
            if std is None:
                std = 1.0 / t.shape[-1]
            src = u[off:off + n] if kind == "uniform" else z[off:off + n]
            t.copy_((src * std + mean).view(t.shape))
            off += n
        del u, z
    for i, (dt, leaves) in enumerate(ints.items()):
        gen = torch.Generator(device=device).manual_seed(_stream_seed(seed, 2 + i))
        lo, hi = (-127, 128) if dt == torch.int8 else (0, 256)
        for group, total in _batches(leaves):
            v = torch.randint(lo, hi, (total,), generator=gen, device=device, dtype=dt)
            off = 0
            for _, t in group:
                t.copy_(v[off:off + t.numel()].view(t.shape))
                off += t.numel()
            del v
    return tensors


def fill_module_(module, seed: int):
    """The seeded values written into ``module``'s own parameters."""
    fill_({n: p.data for n, p in module.named_parameters()}, seed)
    return module


def make(spec: list, seed: int, device) -> dict:
    """Fresh tensors of ``spec`` on ``device``, filled from ``seed``."""
    out = {n: torch.empty(shape, dtype=dt, device=device) for n, shape, dt in spec}
    return fill_(out, seed)
