"""Packed host→device transfer of a parameter subtree (the JAX package's
``utils/packing.py``), for the windowed trainer
(``train/trainer.py``, ``train.encoder_window``).

The leaves of a flat ``{name: tensor}`` dict are concatenated per dtype
into one 1-D buffer each, in their own dtypes, so the round trip is bit
for bit and no bitcast is involved.  Each leaf starts at a 256-byte
boundary of its buffer, so a leaf unpacked on the device is aligned as a
fresh allocation would be.  :func:`make_packed_uploader` keeps the packed
copy in pinned host memory: one ``copy_(..., non_blocking=True)`` per
dtype moves the subtree, and the leaves are views into the device
buffers.
"""

from __future__ import annotations

import math

import torch

_ALIGN_BYTES = 256


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def pack_tree(tree: dict, pin: bool = False):
    """Serialize a flat dict of tensors into per-dtype 1-D host buffers.

    Returns ``(buffers, metas)``: ``buffers`` maps a dtype name to a 1-D
    tensor of that dtype (pinned with ``pin``); ``metas`` is ``(key,
    shape, dtype name, offset in elements)`` per leaf, in sorted key
    order."""
    keys = sorted(tree, key=str)
    metas, sizes, dtypes = [], {}, {}
    for k in keys:
        t = tree[k]
        dt = _dtype_name(t.dtype)
        align = max(_ALIGN_BYTES // t.element_size(), 1)
        off = -(-sizes.get(dt, 0) // align) * align
        metas.append((k, tuple(t.shape), dt, off))
        sizes[dt], dtypes[dt] = off + t.numel(), t.dtype
    buffers = {dt: torch.zeros(n, dtype=dtypes[dt], pin_memory=pin) for dt, n in sizes.items()}
    for (k, shape, dt, off) in metas:
        buffers[dt][off:off + math.prod(shape)].copy_(tree[k].detach().reshape(-1))
    return buffers, metas


def unpack_tree(buffers: dict, metas) -> dict:
    """The leaves of packed ``buffers`` as views (any device)."""
    return {k: buffers[dt][off:off + math.prod(shape)].view(shape)
            for k, shape, dt, off in metas}


class Staged:
    """Device buffers whose copies were issued on a side stream; ``event``
    marks their end."""

    def __init__(self, buffers: dict, event):
        self.buffers, self.event = buffers, event


def make_packed_uploader(tree: dict, device):
    """``(upload, nbytes)`` for the flat dict ``tree``.  The packed host
    copy is pinned when ``device`` is a CUDA device, and ``upload.host``
    gives its leaves as host views (the caller may drop its own copies).
    ``upload.stage()`` allocates the device buffers and issues one
    non-blocking copy per dtype, on a side stream on CUDA, returning a
    :class:`Staged`; ``upload(staged=None)`` makes the current stream
    wait for the staged copies (staging them now if none are given) and
    returns the leaves as views into the device buffers."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    buffers, metas = pack_tree(tree, pin=cuda)
    side = torch.cuda.Stream(device) if cuda else None

    def stage() -> Staged:
        dev = {dt: torch.empty_like(b, device=device) for dt, b in buffers.items()}
        if not cuda:
            for dt, b in buffers.items():
                dev[dt].copy_(b)
            return Staged(dev, None)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for dt, b in buffers.items():
                dev[dt].copy_(b, non_blocking=True)
                # the allocator must not hand the memory out again before
                # the side stream's copy into it has finished
                dev[dt].record_stream(side)
            event = torch.cuda.Event()
            event.record(side)
        return Staged(dev, event)

    def upload(staged: Staged | None = None) -> dict:
        staged = stage() if staged is None else staged
        if staged.event is not None:
            torch.cuda.current_stream(device).wait_event(staged.event)
        return unpack_tree(staged.buffers, metas)

    upload.stage = stage
    upload.host = unpack_tree(buffers, metas)
    return upload, sum(b.numel() * b.element_size() for b in buffers.values())
