"""Optimizer, LR schedule and the trainable-parameter partition.

Schedule: LAVIS ``LinearWarmupCosineLRScheduler`` as the JAX package has
it: a linear warmup over the first ``warmup_steps`` global steps of epoch
0 (``warmup_start_lr`` → ``lr``), then cosine decay by epoch (not by
step): ``lr = min + 0.5 (lr - min)(1 + cos(pi · epoch / max_epoch))``.
Computed in float32 as JAX computes it.

Optimizer: the JAX package's optax chain written out as tensor ops in its
order — ``scale_by_adam`` (eps 1e-8, eps_root 0) → ``add_decayed_weights``
on leaves with more than one dimension (``"adamw"``; ``"adam"`` leaves it
out, the reference's live behaviour) → ``scale_by_learning_rate`` — under
``MultiSteps(accum_grad_iters)``: gradients are averaged over k micro-
steps (Welford: ``acc += (g - acc) / (n + 1)``) and the inner transform
runs and is applied on every k-th, its schedule count mapped back to the
micro-step ``count · k + k − 1`` the reference steps its scheduler at.
``torch.optim.AdamW`` is not this: it decays by ``p · (1 − lr · wd)``
before the Adam step and has no accumulation.

Trainable partition: a regex on each leaf's ``'/'``-joined flax name
(``models/convert_jax.py::flax_params``), as the JAX package matches its
flat parameter paths.
"""

from __future__ import annotations

import math
import re
from typing import Callable

import numpy as np
import torch

from mraudio_tpu_torch.config import TrainConfig
from mraudio_tpu_torch.parallel import comm

# Parameter names that train (the reference trains the LoRA adapters only).
DEFAULT_TRAINABLE_PATTERN = r"(lora_a|lora_b)"


def lavis_warmup_cosine_schedule(cfg: TrainConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """Global step → lr as a float32 number (LAVIS ``step(cur_epoch,
    cur_step)``), rounded as the JAX package's float32 arithmetic rounds."""
    f32 = np.float32
    init, minimum = cfg.lr, cfg.min_lr
    warmup, start, max_epoch = cfg.warmup_steps, cfg.warmup_start_lr, cfg.max_epoch

    def schedule(step: int) -> np.float32:
        step = int(step)
        epoch = step // steps_per_epoch
        warm_lr = f32(start) + f32(init - start) * f32(min(step, warmup)) / f32(warmup)
        cos_lr = f32(minimum) + f32(0.5 * (init - minimum)) * (
            f32(1.0) + np.cos(f32(math.pi) * f32(epoch) / f32(max_epoch)))
        return f32(warm_lr if epoch == 0 and step < warmup else cos_lr)

    return schedule


def trainable_mask(flat: dict, pattern: str = DEFAULT_TRAINABLE_PATTERN) -> dict:
    """``{name: True where the leaf trains}`` over a flat ``{flax name:
    tensor}`` dict."""
    regex = re.compile(pattern)
    return {k: bool(regex.search(k)) for k in flat}


def split_trainable(flat: dict, pattern: str = DEFAULT_TRAINABLE_PATTERN):
    """Split a flat ``{flax name: tensor}`` dict into (trainable, frozen);
    :func:`merge_params` joins them again."""
    mask = trainable_mask(flat, pattern)
    trainable = {k: v for k, v in flat.items() if mask[k]}
    frozen = {k: v for k, v in flat.items() if not mask[k]}
    return trainable, frozen


def merge_params(trainable_flat: dict, frozen_flat: dict) -> dict:
    return {**frozen_flat, **trainable_flat}


def _decay_mask(flat_params: dict) -> dict:
    """LAVIS convention: no weight decay for 1-D leaves (biases, norms)."""
    return {k: v.ndim > 1 for k, v in flat_params.items()}


class Optimizer:
    """The JAX package's optax chain under ``MultiSteps``, over a flat
    ``{name: tensor}`` dict of trainable leaves, with its state as named
    tensors (:meth:`state_dict`).  Counters that advance whatever the
    data (the micro-step, the update count) live on the host; the moments
    and the accumulator live beside their leaves."""

    def __init__(self, cfg: TrainConfig, trainable_flat: dict, steps_per_epoch: int,
                 optimizer: str = "adamw"):
        if optimizer not in ("adamw", "adam"):
            raise ValueError(f"unknown optimizer {optimizer!r}")
        self.kind = optimizer
        self.b1, self.b2 = cfg.betas
        self.eps = 1e-8
        self.weight_decay = cfg.weight_decay
        self.k = max(int(cfg.accum_grad_iters), 1)
        self.schedule = lavis_warmup_cosine_schedule(cfg, steps_per_epoch)
        self.decay = _decay_mask(trainable_flat)
        self.mini_step = 0          # MultiSteps
        self.gradient_step = 0
        self.count = 0              # scale_by_adam's and the schedule's update count
        self.mu = {k: torch.zeros_like(v) for k, v in trainable_flat.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in trainable_flat.items()}
        self.acc = ({k: torch.zeros_like(v) for k, v in trainable_flat.items()}
                    if self.k > 1 else None)

    def inner_lr(self, count: int) -> np.float32:
        """The lr of the ``count``-th update: the schedule at the micro-step
        the reference applies it at."""
        return self.schedule(count if self.k <= 1 else count * self.k + self.k - 1)

    @torch.no_grad()
    def step(self, params: dict, grads: dict, good: torch.Tensor | None = None) -> bool:
        """One micro-step: fold ``grads`` into the accumulator and, on every
        k-th, update the moments and ``params`` in place.  ``good`` (a
        device bool, the nan guard): where False, this micro-step's
        gradients count as zeros and the update it would apply is not
        applied.  Returns whether the inner transform ran."""
        if good is not None:
            grads = {k: torch.where(good, g, torch.zeros((), dtype=g.dtype, device=g.device))
                     for k, g in grads.items()}
        if self.acc is not None:
            n = float(self.mini_step + 1)
            for k, g in grads.items():
                a = self.acc[k]
                a.add_((g - a) / n)
            grads = self.acc
        emit = self.mini_step == self.k - 1
        self.mini_step = (self.mini_step + 1) % self.k
        if not emit:
            return False
        b1, b2 = self.b1, self.b2
        count = self.count + 1
        lr = -self.inner_lr(self.count)
        # 1 - b**count in f32 with b**count correctly rounded, as XLA's pow;
        # the three scalars go to the device once per update
        bc1, bc2 = (np.float32(1) - np.float32(np.float64(np.float32(b)) ** count)
                    for b in (b1, b2))
        scalars = {}
        for k, p in params.items():
            g = grads[k]
            key = (g.device, g.dtype)
            if key not in scalars:
                scalars[key] = torch.tensor([bc1, bc2, lr], dtype=g.dtype).to(g.device)
            bc1_t, bc2_t, lr_t = scalars[key]
            mu = (1 - b1) * g + b1 * self.mu[k]
            nu = (1 - b2) * g ** 2 + b2 * self.nu[k]
            u = (mu / bc1_t) / (torch.sqrt(nu / bc2_t + 0.0) + self.eps)
            if self.kind == "adamw" and self.decay[k]:
                u = u + self.weight_decay * p
            u = lr_t * u
            if good is not None:
                u = torch.where(good, u, torch.zeros((), dtype=u.dtype, device=g.device))
            p.copy_((p + u).to(p.dtype))
            self.mu[k], self.nu[k] = mu, nu
        if self.acc is not None:
            for a in self.acc.values():
                a.zero_()
        self.count = count
        self.gradient_step += 1
        return True

    def state_dict(self) -> dict:
        """``{name: tensor}``: the counters as 0-d int64 tensors, then
        ``mu/<leaf>``, ``nu/<leaf>`` and (k > 1) ``acc/<leaf>``."""
        out = {name: torch.tensor(getattr(self, name), dtype=torch.int64)
               for name in ("mini_step", "gradient_step", "count")}
        for prefix, part in (("mu", self.mu), ("nu", self.nu), ("acc", self.acc or {})):
            out.update({f"{prefix}/{k}": v for k, v in part.items()})
        return out

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        for name in ("mini_step", "gradient_step", "count"):
            setattr(self, name, int(state[name]))
        for prefix, part in (("mu", self.mu), ("nu", self.nu), ("acc", self.acc or {})):
            for k, v in part.items():
                v.copy_(state[f"{prefix}/{k}"])


def build_optimizer(cfg: TrainConfig, trainable_flat: dict, steps_per_epoch: int,
                    optimizer: str = "adamw") -> Optimizer:
    return Optimizer(cfg, trainable_flat, steps_per_epoch, optimizer)


def global_grad_norm(grads: dict, sharded=(), group=None) -> torch.Tensor:
    """The f32 L2 norm of a gradient dict as one device would take it:
    each leaf in ``sharded`` is this rank's shard of a leaf split over
    ``group`` (the model ranks), whose squares are summed across it, so
    every element counts once; every other leaf is whole on each rank
    and counts once."""
    squares = {k: g.float().square().sum() for k, g in grads.items()}
    split = sum((v for k, v in squares.items() if k in sharded), torch.zeros(()))
    whole = sum((v for k, v in squares.items() if k not in sharded), torch.zeros(()))
    dev = next(iter(squares.values())).device if squares else torch.device("cpu")
    return torch.sqrt(comm.all_reduce_sum(split.to(dev), group) + whole.to(dev))
