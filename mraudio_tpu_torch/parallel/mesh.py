"""The (data, model) device mesh of a multi-process launch.

The JAX package's ``parallel/mesh.py`` builds one ``jax.sharding.Mesh``
over every chip in one process and lets XLA emit the collectives.  The
port runs one process per device and issues its collectives itself
(``parallel/comm.py``): a :class:`Mesh` is this process's place in the
grid, with the process groups of its two axes.

* ``data`` — batch parallelism (the reference's only strategy), and the
  axis the frozen encoders are ZeRO-3-sharded over;
* ``model`` — Megatron tensor parallelism of the LLM (heads, MLP width
  and vocabulary sharded).

Ranks lie row-major over ``(data, model)``, as the JAX package's
``reshape(data, model)`` of its device list: rank ``d * model + m`` has
coordinates ``(d, m)``, so a model group is ``model`` consecutive ranks.
"""

from __future__ import annotations

import dataclasses

import torch.distributed as dist

from mraudio_tpu_torch.config import MeshConfig


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This process's coordinates in a ``data x model`` grid and the
    groups of its axes (None for an axis of size 1: nothing to talk to)."""

    data: int = 1
    model: int = 1
    data_index: int = 0
    model_index: int = 0
    data_group: object = None       # the ranks that share this rank's model index
    model_group: object = None      # the ranks that share this rank's data index

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def num_devices(self) -> int:
        return self.data * self.model

    @property
    def rank(self) -> int:
        return self.data_index * self.model + self.model_index

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.data_index if axis == "data" else self.model_index

    def group(self, axis: str):
        return self.data_group if axis == "data" else self.model_group


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(cfg: MeshConfig | None = None) -> Mesh:
    """This process's place in a (data, model) mesh.  With ``cfg=None``
    every process of the launch is a data rank (pure DP).  A mesh of more
    than one device needs a process group of exactly that many processes
    (one per device): any other world size raises, as the JAX package
    raises for a mesh larger than its devices."""
    world, rank = _world()
    if cfg is None:
        cfg = MeshConfig(data=world, model=1)
    n = cfg.data * cfg.model
    if n != world:
        raise ValueError(
            f"mesh {cfg.data}x{cfg.model} needs {n} devices, have {world} "
            "(one process per device: launch exactly data x model processes)")
    if n == 1:
        return Mesh()
    data_group = model_group = None
    # every rank creates every group, in the same order
    for d in range(cfg.data):
        ranks = [d * cfg.model + m for m in range(cfg.model)]
        group = dist.new_group(ranks) if cfg.model > 1 else None
        if rank in ranks:
            model_group = group
    for m in range(cfg.model):
        ranks = [d * cfg.model + m for d in range(cfg.data)]
        group = dist.new_group(ranks) if cfg.data > 1 else None
        if rank in ranks:
            data_group = group
    return Mesh(cfg.data, cfg.model, rank // cfg.model, rank % cfg.model,
                data_group, model_group)


def mesh_for(cfg: MeshConfig) -> Mesh | None:
    """This process's mesh, or None when it runs alone: a mesh of more
    than one device, and any launch of more than one process, go through
    :func:`make_mesh`, which raises unless the two sizes agree."""
    if cfg.num_devices == 1 and _world()[0] == 1:
        return None
    return make_mesh(cfg)


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    data = mesh.shape["data"]
    if global_batch % data:
        raise ValueError(f"global batch {global_batch} not divisible by data={data}")
    return global_batch // data
