"""Sharding the sampler over a mesh of ``torch.distributed`` ranks
(:mod:`.sharding`)."""

from .sharding import (Mesh, chain_submesh_size, collective_report,
                       init_from_env, make_mesh, mesh_layout,
                       pulsar_submesh_size, shard_carry, shard_compiled,
                       spawn, validate_chains)

__all__ = ["Mesh", "chain_submesh_size", "collective_report",
           "init_from_env", "make_mesh", "mesh_layout",
           "pulsar_submesh_size", "shard_carry", "shard_compiled", "spawn",
           "validate_chains"]
