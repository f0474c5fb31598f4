"""The port's training loss and gradients against the JAX package's
``_loss_fn`` and ``jax.value_and_grad``, from the same parameters and
arrays: the tiny configuration in f32, LoRA dropout off (JAX's dropout
bits cannot be reproduced), a non-zero LoRA B.

Cases (two, each one JAX compile): the train-time crop and flip with the
saliency head and its labels; ``chunk=8``, so that the CE crosses chunk
edges and pads the last, with labels at -100 beyond the prompt.  The loss agrees within rel 1e-5 (f32 sums in
another order) and each trainable leaf's gradient within 1e-4 of that
leaf's largest |g|.  ``grad_checkpoint`` on and off give the same bits on
the CPU, and the port's dropout keeps 1 - rate of its input and draws
the same mask for the same key."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mraudio_tpu.config import tiny_data_config as j_tiny_data
from mraudio_tpu.config import tiny_model_config as j_tiny
from mraudio_tpu.models.xinstructblip import XInstructBLIP as JModel
from mraudio_tpu.train.optim import merge_params as j_merge
from mraudio_tpu.train.optim import split_trainable as j_split
from mraudio_tpu_torch.config import tiny_data_config, tiny_model_config
from mraudio_tpu_torch.data.dataset import Batch
from mraudio_tpu_torch.models.convert_jax import flax_params, init_random_, torch_name
from mraudio_tpu_torch.models.llama import lora_dropout
from mraudio_tpu_torch.models.xinstructblip import XInstructBLIP

torch.set_num_threads(1)

PATTERN = XInstructBLIP.TRAINABLE_PATTERN


def f32_cfg(cfg, saliency=False):
    """``cfg`` in f32 with LoRA dropout off."""
    return cfg.replace(llm=cfg.llm.replace(dtype="float32"), vit=cfg.vit.replace(dtype="float32"),
                       beats=cfg.beats.replace(dtype="float32"),
                       qformer=cfg.qformer.replace(dtype="float32"),
                       lora=cfg.lora.replace(dropout=0.0), saliency_head=saliency)


def port_model(cfg, audio_cfg, seed=3):
    """The port's model with seeded weights and a non-zero LoRA B."""
    model = XInstructBLIP(cfg, audio_cfg=audio_cfg, device="cpu")
    init_random_(model, seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_b"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    return model


def jax_tree(model) -> dict:
    """The JAX package's nested parameter tree of the port's weights."""
    tree = {}
    for name, t in flax_params(model).items():
        *scopes, leaf = name.split("/")
        node = tree
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = t.numpy().copy()
    return tree


def train_batch(seed=0, b=2, t=4):
    rng = np.random.default_rng(seed)
    audio = tiny_data_config().audio
    n_audio = audio.hop_length * (t * audio.mel_frames_per_chunk - 1) + audio.win_length
    return Batch(
        video=rng.integers(0, 256, (b, t, 28, 28, 3)).astype(np.uint8),
        audio=(rng.standard_normal((b, n_audio)) * 3000).astype(np.int16),
        timestamps=np.array([[3, 40, 80, 120], [5, 50, 90, 130]], np.int32)[:b],
        duration=[150] * b,
        text_input=["find the dog running", "where is the cat"][:b],
        text_output=["[[30, 60]]", "[[80, 100], [120, 140]]"][:b],
        qid=list(range(b)), query=["a", "b"][:b], vid=["v0", "v1"][:b],
        valid=np.ones(b, bool))


@pytest.fixture(scope="module")
def models():
    """{saliency: (JAX model, JAX tree, port model)}."""
    out = {}
    for sal in (False, True):
        tm = port_model(f32_cfg(tiny_model_config(), sal), tiny_data_config().audio)
        jm = JModel(f32_cfg(j_tiny(), sal), audio_cfg=j_tiny_data().audio)
        out[sal] = (jm, jax_tree(tm), tm)
    return out


def _jax_loss_and_grads(jm, tree, arrays, crop, chunk):
    tr, fr = j_split(tree, PATTERN)
    if chunk != 512:
        # a model of its own: the jitted loss is traced once per instance
        jm = JModel(jm.cfg, audio_cfg=jm.audio_cfg)
        real = jm._chunked_ce
        jm._chunked_ce = lambda params, h, l: real(params, h, l, chunk=chunk)

    def loss_fn(t):
        return jm._loss_fn(j_merge(t, fr), *[jnp.asarray(a) for a in arrays],
                           crop_params=None if crop is None else jnp.asarray(crop), n_frms=4)

    loss, grads = jax.value_and_grad(loss_fn)(tr)
    return float(loss), {"/".join(k): np.asarray(v) for k, v in grads.items()}


def _port_loss_and_grads(tm, batch, crop, chunk):
    real = tm._chunked_ce
    tm._chunked_ce = lambda h, l: real(h, l, chunk=chunk)
    params = dict(tm.named_parameters())
    leaves = {k: params[torch_name(tuple(k.split("/")))]
              for k in flax_params(tm) if __import__("re").search(PATTERN, k)}
    try:
        for p in leaves.values():
            p.requires_grad_(True)
        loss = tm.loss(batch=batch, crop_params=crop)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        loss = loss.detach()
    finally:
        tm._chunked_ce = real
        for p in leaves.values():
            p.requires_grad_(False)
    return float(loss), {k: g.numpy() for k, g in zip(leaves, grads)}


CASES = {
    "crop_and_saliency": dict(crop=True, saliency=True, chunk=512, mask_tail=False),
    "chunk8_and_ignored_labels": dict(crop=False, saliency=False, chunk=8, mask_tail=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_grads_match_jax(models, case):
    c = CASES[case]
    jm, tree, tm = models[c["saliency"]]
    batch = train_batch()
    crop = (np.array([[1, 2, 24, 26, 1], [0, 3, 25, 22, 0]], np.int32) if c["crop"] else None)
    arrays = list(jm.loss_arrays(batch))
    if c["mask_tail"]:
        # the last target tokens of row 0 carry no loss
        labels = arrays[10].copy()
        valid = np.nonzero(labels[0] != -100)[0]
        labels[0, valid[-3:]] = -100
        arrays[10] = labels
        real = tm.loss_arrays
        tm.loss_arrays = lambda b: tuple(arrays)
    try:
        port_loss, port_grads = _port_loss_and_grads(tm, batch, crop, c["chunk"])
    finally:
        if c["mask_tail"]:
            tm.loss_arrays = real
    jax_loss, jax_grads = _jax_loss_and_grads(jm, tree, arrays, crop, c["chunk"])
    assert np.isfinite(port_loss)
    assert abs(port_loss - jax_loss) <= 1e-5 * abs(jax_loss), (port_loss, jax_loss)
    assert sorted(port_grads) == sorted(jax_grads)
    assert any(k.startswith("saliency_head") for k in port_grads) == c["saliency"]
    for k, g in jax_grads.items():
        scale = max(float(np.abs(g).max()), 1e-30)
        assert float(np.abs(port_grads[k] - g).max()) <= 1e-4 * scale, k


def test_grad_checkpoint_bit_identical(models):
    _, _, tm = models[True]
    batch, crop = train_batch(1), np.array([[0, 0, 28, 28, 1], [2, 1, 25, 25, 0]], np.int32)
    runs = []
    for remat in (False, True):
        tm.llm.cfg = tm.llm.cfg.replace(grad_checkpoint=remat)
        for layer in tm.llm.layers:
            layer.attn.cfg = tm.llm.cfg
        try:
            runs.append(_port_loss_and_grads(tm, batch, crop, 8))
        finally:
            tm.llm.cfg = tm.llm.cfg.replace(grad_checkpoint=False)
    (l0, g0), (l1, g1) = runs
    assert l0 == l1
    assert all(np.array_equal(g0[k], g1[k]) for k in g0)


def test_lora_dropout_rate_and_determinism():
    x = torch.ones((64, 512))
    a = lora_dropout(x, 0.05, (71, 3, 0, 1))
    kept = (a != 0).float().mean().item()
    assert abs(kept - 0.95) < 0.01
    assert torch.allclose(a[a != 0], torch.tensor(1 / 0.95))
    assert torch.equal(a, lora_dropout(x, 0.05, (71, 3, 0, 1)))
    assert not torch.equal(a, lora_dropout(x, 0.05, (71, 4, 0, 1)))
    assert not torch.equal(a, lora_dropout(x, 0.05, (71, 3, 0, 2)))


@pytest.mark.parametrize("s,kv,causal", [(21, 21, True), (5, 21, False), (40, 37, True)])
def test_chunked_attention_backward_matches_dense(s, kv, causal):
    """The tile-by-tile backward of ``chunked_attention`` (8-row tiles and
    chunks: full chunks, a ragged tail, a tile of at most 16 queries,
    fully masked rows) against autograd through a dense f32 softmax."""
    from mraudio_tpu_torch.ops.attention import chunked_attention

    gen = torch.Generator().manual_seed(s + kv)
    b, h, d = 2, 3, 16
    q, k, v, dout = (torch.randn(shape, generator=gen, dtype=torch.float64).float()
                     for shape in ((b, s, h, d), (b, kv, h, d), (b, kv, h, d), (b, s, h, d)))
    mask = torch.ones((b, kv), dtype=torch.int32)
    mask[1, :3] = 0               # row 1's first queries see no key
    mask[0, -2:] = 0

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves)
        return out.detach(), torch.autograd.grad(out, leaves, dout)

    def dense(qq, kk, vv):
        logits = torch.einsum("bqhd,bkhd->bhqk", qq, kk) / d ** 0.5
        ok = (mask[:, None, None, :] > 0)
        if causal:
            ok = ok & (torch.arange(kv)[None, :] <= torch.arange(s)[:, None])
        logits = torch.where(ok, logits, -1e30)
        p = torch.where(ok, torch.softmax(logits, dim=-1), 0.0)
        return torch.einsum("bhqk,bkhd->bqhd", p, vv)

    out, g = grads(lambda qq, kk, vv: chunked_attention(
        qq, kk, vv, mask, causal=causal, block_k=8, block_q=8, kv_bshd=True, q_bshd=True))
    ref, g_ref = grads(dense)
    with torch.no_grad():
        plain = chunked_attention(q, k, v, mask, causal=causal, block_k=8, block_q=8,
                                  kv_bshd=True, q_bshd=True)
    assert torch.equal(out, plain)       # the forward under autograd keeps its bits
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    for got, want in zip(g, g_ref):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_weights_carry_over_both_ways(models):
    """The JAX tree of the port's weights, saliency head and LoRA leaves
    included, loads back into a fresh port model bit for bit and has the
    JAX package's names and shapes."""
    from mraudio_tpu_torch.models.convert_jax import load_jax_params_

    jm, tree, tm = models[True]
    shapes = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0), jit=False))
    assert jax.tree_util.tree_structure(shapes) == jax.tree_util.tree_structure(tree)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: a.shape == b.shape, shapes, tree))
    fresh = load_jax_params_(XInstructBLIP(tm.cfg, audio_cfg=tm.audio_cfg, device="cpu"), tree)
    theirs = dict(fresh.named_parameters())
    assert all(torch.equal(p, theirs[n]) for n, p in tm.named_parameters())
