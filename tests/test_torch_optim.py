"""The port's optimizer and schedule (``train/optim.py``) against the JAX
package's optax chain: the LAVIS warmup-cosine schedule within one f32
ulp, seven micro-steps of fixed gradients under ``MultiSteps`` (k = 1
and 2, ``adamw`` and ``adam``, a 1-D leaf exempt from decay) within rel
1e-6 in the leaves and both moments, and the trainable partition."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from mraudio_tpu.config import TrainConfig as JTrainConfig
from mraudio_tpu.train import optim as joptim
from mraudio_tpu_torch.config import TrainConfig
from mraudio_tpu_torch.train import optim

SHAPES = {"a/lora_a": (6, 2), "a/lora_b": (2, 5), "head/bias": (5,)}


def _cfg(cls, k):
    return cls(lr=3e-3, weight_decay=0.05, warmup_steps=3, warmup_start_lr=1e-6,
               max_epoch=3, accum_grad_iters=k)


def test_schedule_within_one_ulp():
    kw = dict(lr=3e-4, min_lr=1e-6, warmup_steps=10, warmup_start_lr=1e-8, max_epoch=4)
    ours = optim.lavis_warmup_cosine_schedule(TrainConfig(**kw), steps_per_epoch=7)
    theirs = joptim.lavis_warmup_cosine_schedule(JTrainConfig(**kw), steps_per_epoch=7)
    for step in list(range(0, 16)) + [20, 21, 27, 28, 29, 100]:
        a, b = np.float32(ours(step)), np.float32(np.asarray(theirs(step)))
        assert abs(int(a.view(np.int32)) - int(b.view(np.int32))) <= 1, (step, a, b)


def _grads(n):
    rng = np.random.default_rng(5)
    return [{k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
            for _ in range(n)]


@pytest.mark.parametrize("kind", ["adamw", "adam"])
@pytest.mark.parametrize("k", [1, 2])
def test_seven_micro_steps_match_optax(k, kind):
    rng = np.random.default_rng(1)
    init = {name: rng.standard_normal(s).astype(np.float32) for name, s in SHAPES.items()}
    jflat = {tuple(n.split("/")): jnp.asarray(v) for n, v in init.items()}
    tx = joptim.build_optimizer(_cfg(JTrainConfig, k), jflat, steps_per_epoch=3,
                                optimizer=kind)
    jstate = tx.init(jflat)
    update = jax.jit(lambda g, st, p: tx.update(g, st, p))   # one compile, not one per op
    ours = {n: torch.from_numpy(v.copy()) for n, v in init.items()}
    opt = optim.build_optimizer(_cfg(TrainConfig, k), ours, steps_per_epoch=3, optimizer=kind)
    for g in _grads(7):
        upd, jstate = update({tuple(n.split("/")): jnp.asarray(v) for n, v in g.items()},
                             jstate, jflat)
        jflat = optax.apply_updates(jflat, upd)
        opt.step(ours, {n: torch.from_numpy(v) for n, v in g.items()})
    adam = (jstate.inner_opt_state if k > 1 else jstate)[0]
    assert opt.count == int(adam.count) == 7 // k
    for n in SHAPES:
        key = tuple(n.split("/"))
        for mine, theirs in ((ours[n], jflat[key]), (opt.mu[n], adam.mu[key]),
                             (opt.nu[n], adam.nu[key])):
            np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=1e-6, atol=1e-9)
    if k > 1:
        assert opt.mini_step == int(jstate.mini_step)
        for n in SHAPES:
            np.testing.assert_allclose(opt.acc[n].numpy(),
                                       np.asarray(jstate.acc_grads[tuple(n.split("/"))]),
                                       rtol=1e-6, atol=1e-9)


def test_nan_guard_masks_a_micro_step():
    """A micro-step flagged not finite counts as zero gradients and applies
    no update: at the first micro-step of an accumulation nothing moves."""
    ours = {n: torch.ones(s) for n, s in SHAPES.items()}
    opt = optim.build_optimizer(_cfg(TrainConfig, 2), ours, steps_per_epoch=3)
    bad = {n: torch.full(s, float("nan")) for n, s in SHAPES.items()}
    opt.step(ours, bad, good=torch.tensor(False))
    assert all(bool((p == 1).all()) for p in ours.values())
    assert all(bool((a == 0).all()) for a in opt.acc.values())
    opt.step(ours, {n: torch.ones(s) for n, s in SHAPES.items()}, good=torch.tensor(True))
    assert all(bool(torch.isfinite(p).all()) and bool((p != 1).any()) for p in ours.values())


def test_state_dict_round_trips():
    ours = {n: torch.ones(s) for n, s in SHAPES.items()}
    opt = optim.build_optimizer(_cfg(TrainConfig, 2), ours, steps_per_epoch=3)
    for g in _grads(3):
        opt.step(ours, {n: torch.from_numpy(v) for n, v in g.items()})
    state = opt.state_dict()
    fresh = optim.build_optimizer(_cfg(TrainConfig, 2), ours, steps_per_epoch=3)
    fresh.load_state_dict(state)
    again = fresh.state_dict()
    assert sorted(state) == sorted(again)
    assert all(torch.equal(state[k], again[k]) for k in state)


def test_partition_matches_jax():
    rng = np.random.default_rng(0)
    names = ["llm/layer_0/attn/q_proj/lora_a", "llm/layer_0/attn/q_proj/lora_b",
             "llm/layer_0/attn/q_proj/w_int8", "saliency_head/fc1/kernel",
             "saliency_head/fc1/bias", "vit/block_0/norm1/LayerNorm_0/scale"]
    flat = {n: rng.standard_normal((2, 3) if "kernel" in n or "lora" in n else (3,))
            for n in names}
    jflat = {tuple(n.split("/")): v for n, v in flat.items()}
    tree = jax.tree_util.tree_map(np.asarray, joptim.merge_params(jflat, {}))
    for pattern in (optim.DEFAULT_TRAINABLE_PATTERN, r"(lora_a|lora_b|saliency_head)"):
        tr, fr = optim.split_trainable(flat, pattern)
        jtr, jfr = joptim.split_trainable(tree, pattern)
        assert sorted(tr) == sorted("/".join(k) for k in jtr)
        assert sorted(fr) == sorted("/".join(k) for k in jfr)
        assert optim.merge_params(tr, fr) == flat
        assert optim.trainable_mask(flat, pattern) == {n: n in tr for n in flat}
    assert optim._decay_mask(flat) == {n: v.ndim > 1 for n, v in flat.items()}
