"""The parallel layer: domain-sharded and batch proving over
``torch.distributed`` (counterpart of ``zkt_plonk_tpu/parallel``)."""

from .batch import BatchProver
from .mesh import Mesh, Mesh2D, gather_rows, init_distributed, make_mesh, shard_rows
from .prover import ShardedProver

__all__ = [
    "BatchProver", "Mesh", "Mesh2D", "ShardedProver", "gather_rows", "init_distributed",
    "make_mesh", "shard_rows",
]
