"""Device and dtype helpers shared by the port's entry points, and the
process group of a multi-process launch.

One process drives one device.  Under ``python -m torch.distributed.run``
(torchrun) each process reads its place from the launcher's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT``):
:func:`init_distributed` joins the group over NCCL with the process's
card ``cuda:LOCAL_RANK``, or over gloo when the entry point runs on the
CPU.  A missing card or a PyTorch without NCCL raises; nothing falls
back to the CPU.
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  Entry points default to
    ``"cuda"``; asking for CUDA without a card raises instead of running
    on the CPU.  A bare ``"cuda"`` in a process of a distributed launch
    is the process's own card, ``cuda:LOCAL_RANK``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run the plain versions"
        )
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return dev


def launched_distributed() -> bool:
    """True in a process that a distributed launcher started (torchrun
    sets ``WORLD_SIZE`` and ``RANK``)."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def init_distributed(device="cuda", init_method: str | None = None) -> torch.device:
    """Join the launch's process group (once) and return this process's
    device: NCCL on ``cuda:LOCAL_RANK``, gloo on the CPU.  ``init_method``
    defaults to the launcher's environment (``env://``); the rank and
    world size come from ``RANK`` and ``WORLD_SIZE``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = resolve_device(device)
        if dev.index is None:
            dev = torch.device("cuda", 0)
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA process group needs NCCL, which this PyTorch lacks")
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"no process group backend for device {dev}")
    if not dist.is_initialized():
        if not launched_distributed() and init_method is None:
            raise RuntimeError(
                "a mesh or --distributed needs a distributed launch: run the entry point "
                "under `python -m torch.distributed.run --nproc-per-node N -m ...`, which "
                "sets RANK, WORLD_SIZE, LOCAL_RANK and MASTER_ADDR/MASTER_PORT")
        kw = {}
        if init_method is not None:
            kw = dict(init_method=init_method, rank=int(os.environ["RANK"]),
                      world_size=int(os.environ["WORLD_SIZE"]))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", **kw)
    return dev


def shutdown_distributed() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
        dist.destroy_process_group()


@contextlib.contextmanager
def process_group(device="cuda", needed: bool = True):
    """An entry point's process group: joined on entry when ``needed``
    (and not joined already), left on exit if joined here; yields the
    device this process runs on."""
    if not needed:
        yield device
        return
    owned = not dist.is_initialized()
    dev = init_distributed(device)
    try:
        yield dev
    finally:
        if owned:
            shutdown_distributed()


def is_main_process() -> bool:
    """Rank 0 of the launch, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0
