"""The collectives the partition rules imply, written out over plain
local-shard tensors (the JAX package leaves them to GSPMD).

Tensor parallelism (Megatron), over the ``model`` group:

* :func:`enter_tp` — the input of a column-parallel block: identity
  forward, all-reduce of the gradient backward ("f");
* :func:`row_reduce` — the output of a row-parallel projection: the f32
  partial sums added across the ranks, identity backward ("g").  A
  decode-shaped call (at most :data:`~mraudio_tpu_torch.models.layers.
  DECODE_ROWS` rows) all-gathers the partials and adds them in rank
  order, so a row's sum never depends on the rows beside it (the
  speculative decoders reproduce the one-token steps' tokens) and every
  rank holds the same bits; longer calls all-reduce;
* :func:`gather_last` — vocab-sharded logits gathered whole (backward:
  this rank's columns), so every decoder's argmax sees the full
  vocabulary and the lowest index wins ties as ``jnp.argmax``;
* :func:`vocab_embed` — the vocab-sharded embedding: a masked local
  lookup, then an all-reduce (exact: one rank holds each row).

Sequence parallelism (``seq_shard``), over the ``model`` group along S:
:func:`split_seq` (keep this rank's chunk), :func:`gather_seq` (all-
gather before the column-parallel matmuls; backward reduce-scatter),
:func:`scatter_seq` (reduce-scatter after the row-parallel ones;
backward all-gather) and :func:`gather_seq_replicated` (the final
all-gather; backward this rank's chunk).  S is zero-padded to a
multiple of the group size, so the last chunk may carry padding rows.

ZeRO-3 over ``data``: :func:`all_gather_cat` puts a frozen encoder leaf
back together where it is read (no gradient).

Every function takes the group (None for an axis of size 1, where it is
the identity) and works on gloo (CPU) and NCCL (CUDA) alike.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from mraudio_tpu_torch.models.layers import DECODE_ROWS


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _gather_list(x: torch.Tensor, group) -> list:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x, group=group)
    return parts


def all_gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    if group is None:
        return x
    return torch.cat(_gather_list(x, group), dim=dim)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group (a new tensor; no gradient)."""
    if group is None:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, group=group)
    return y


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def all_reduce_sum_(tensors: dict, names, group) -> None:
    """Replace ``tensors[k]`` for each ``k`` in ``names`` by its sum over
    ``group``, all in one flat all-reduce (no gradient)."""
    names = list(names)
    if group is None or not names:
        return
    flat = torch.cat([tensors[k].detach().reshape(-1) for k in names])
    dist.all_reduce(flat, group=group)
    offset = 0
    for k in names:
        n = tensors[k].numel()
        tensors[k] = flat[offset:offset + n].view_as(tensors[k])
        offset += n


def ordered_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The group's ``x`` added in rank order, ``((x_0 + x_1) + x_2) + ...``,
    the same bits on every rank whatever the message size."""
    parts = _gather_list(x, group)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


class _EnterTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _RowReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, partial, group):
        rows = partial.numel() // max(partial.shape[-1], 1)
        if rows <= DECODE_ROWS:
            return ordered_sum(partial, group)
        out = partial.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def enter_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient is all-reduced over ``group``."""
    if group is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _EnterTP.apply(x, group)


def row_reduce(partial: torch.Tensor, group) -> torch.Tensor:
    """The sum of the group's partials (identity backward)."""
    if group is None:
        return partial
    return _RowReduce.apply(partial, group)


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        return all_gather_cat(x, -1, group)

    @staticmethod
    def backward(ctx, grad):
        r = group_rank(ctx.group)
        return grad[..., r * ctx.width:(r + 1) * ctx.width].contiguous(), None


def gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """All-gather along the last axis (vocab-sharded logits); the
    gradient of this rank's columns flows back."""
    if group is None:
        return x
    return _GatherLast.apply(x, group)


@torch.no_grad()
def vocab_embed(ids: torch.Tensor, table: torch.Tensor, group) -> torch.Tensor:
    """Rows of a vocab-sharded embedding table: this rank holds ids
    ``[r * n, (r + 1) * n)``; the others contribute zeros."""
    n = table.shape[0]
    lo = group_rank(group) * n
    ids = ids.long()
    local = (ids >= lo) & (ids < lo + n)
    rows = torch.nn.functional.embedding(torch.where(local, ids - lo, 0), table)
    rows = torch.where(local[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                           device=rows.device))
    return all_reduce_sum(rows, group)


# ---------------------------------------------------------------------------
# sequence parallelism along axis 1 of (B, S, D)


def seq_chunk(s: int, group) -> int:
    """Rows per rank of an S-long sequence (S padded to the group size)."""
    m = group_size(group)
    return -(-s // m)


def _pad_seq(x: torch.Tensor, s_pad: int) -> torch.Tensor:
    if x.shape[1] == s_pad:
        return x
    return torch.nn.functional.pad(x, (0, 0) * (x.dim() - 2) + (0, s_pad - x.shape[1]))


def _local_chunk(x: torch.Tensor, group) -> torch.Tensor:
    c = seq_chunk(x.shape[1], group)
    r = group_rank(group)
    return _pad_seq(x, c * group_size(group))[:, r * c:(r + 1) * c].contiguous()


def _reduce_scatter_seq(x: torch.Tensor, group) -> torch.Tensor:
    """(B, S, ...) partials → this rank's (B, c, ...) chunk of their sum."""
    m = group_size(group)
    c = seq_chunk(x.shape[1], group)
    xp = _pad_seq(x, c * m)
    chunks = [xp[:, i * c:(i + 1) * c].contiguous() for i in range(m)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=group)
    return out


class _SplitSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.s = group, x.shape[1]
        return _local_chunk(x, group)

    @staticmethod
    def backward(ctx, grad):
        return all_gather_cat(grad, 1, ctx.group)[:, :ctx.s], None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, s):
        ctx.group = group
        return all_gather_cat(x, 1, group)[:, :s]

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter_seq(grad, ctx.group), None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, partial, group):
        ctx.group, ctx.s = group, partial.shape[1]
        return _reduce_scatter_seq(partial, group)

    @staticmethod
    def backward(ctx, grad):
        return all_gather_cat(grad, 1, ctx.group)[:, :ctx.s], None


class _GatherSeqReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, s):
        ctx.group = group
        return all_gather_cat(x, 1, group)[:, :s]

    @staticmethod
    def backward(ctx, grad):
        return _local_chunk(grad, ctx.group), None, None


def split_seq(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's chunk of a replicated (B, S, ...) tensor (S zero-
    padded to a multiple of the group size)."""
    return _SplitSeq.apply(x, group)


def gather_seq(x: torch.Tensor, group, s: int) -> torch.Tensor:
    """The whole (B, s, ...) sequence from the ranks' chunks, feeding
    tensor-parallel compute (backward: reduce-scatter of the partial
    gradients)."""
    return _GatherSeq.apply(x, group, s)


def scatter_seq(partial: torch.Tensor, group) -> torch.Tensor:
    """This rank's chunk of the sum of the ranks' (B, S, ...) partials."""
    return _ScatterSeq.apply(partial, group)


def gather_seq_replicated(x: torch.Tensor, group, s: int) -> torch.Tensor:
    """The whole (B, s, ...) sequence from the ranks' chunks, feeding
    compute that every rank repeats (backward: this rank's chunk)."""
    return _GatherSeqReplicated.apply(x, group, s)


# ---------------------------------------------------------------------------
# host records


def allgather_results(results: list, group=None) -> list:
    """Every process's list of JSON-able records, concatenated in rank
    order (the JAX package's ``_allgather_results``): the JSON payloads
    are ragged, so their lengths go first, then the payloads padded to the
    longest, then each is trimmed.  One process: ``results`` itself."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size(group) == 1:
        return results
    import json

    group = group or dist.group.WORLD

    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    payload = json.dumps(results).encode()
    lengths = [int(n) for n in torch.cat(_gather_list(
        torch.tensor([len(payload)], dtype=torch.int64, device=dev), group)).tolist()]
    buf = torch.zeros(max(lengths), dtype=torch.uint8, device=dev)
    buf[:len(payload)] = torch.frombuffer(bytearray(payload), dtype=torch.uint8).to(dev)
    out = []
    for row, n in zip(_gather_list(buf, group), lengths):
        out.extend(json.loads(bytes(row[:n].cpu().numpy()).decode()))
    return out
