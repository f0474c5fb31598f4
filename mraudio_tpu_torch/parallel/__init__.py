"""Parallelism: the (data, model) mesh of a one-process-per-device
launch (``mesh.py``), the partition rules and the slicing that applies
them (``partition.py``), and the collectives they imply (``comm.py``)."""

from mraudio_tpu_torch.parallel.mesh import Mesh, local_batch_size, make_mesh, mesh_for
from mraudio_tpu_torch.parallel.partition import (FSDP_PREFIXES, LLM_RULES, gather_params,
                                                  param_specs, partition_spec, shard_module_,
                                                  shard_params)

__all__ = ["FSDP_PREFIXES", "LLM_RULES", "Mesh", "gather_params", "local_batch_size",
           "make_mesh", "mesh_for", "param_specs", "partition_spec", "shard_module_",
           "shard_params"]
