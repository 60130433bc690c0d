"""Process groups and the collectives of the parallel layer.

Counterpart of ``zkt_plonk_tpu/parallel/mesh.py``.  JAX runs one Python
controller over a device mesh; ``torch.distributed`` runs one process per
rank (SPMD), so a mesh here is this rank's view of it: a process group, its
size ``D``, this rank's index ``d`` in it and the device its shards live on.

Axes, as in the JAX package:

* ``poly`` — domain sharding: a polynomial's n axis is split in D
  contiguous blocks, block d on the group's rank d;
* ``data`` — proof batches: the rows of a ``(data, poly)`` mesh are
  ``dist.new_group`` subgroups, each proving its own witnesses.

Every cross-rank exchange of ``parallel/ops.py`` goes through one of the
three ``Mesh`` methods below, which stand for the JAX collectives:

* ``all_gather``  — ``lax.all_gather``  (``dist.all_gather``, stacked);
* ``all_to_all``  — ``lax.all_to_all(..., tiled=True)``
  (``dist.all_to_all_single``);
* ``exchange``    — ``lax.ppermute`` (``dist.batch_isend_irecv``);

and ``lax.axis_index`` / ``lax.axis_size`` are ``Mesh.d`` / ``Mesh.D``.

Transports: NCCL carries CUDA tensors and gloo host tensors.  A mesh on the
card over gloo (the two-process rehearsal on one card, where NCCL refuses
two ranks on one GPU) copies every exchanged tensor to the host and back;
its ``transport`` says so.  That copy is taken only when gloo was asked for.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import _cuda

AXIS = "poly"


def init_distributed(
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
) -> bool:
    """Initialise the default process group for one process per rank.

    With ``init_method`` omitted it reads the environment ``torchrun``
    sets (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK) and
    returns False, doing nothing, when MASTER_ADDR is absent, so a
    single-process run needs no configuration.  ``backend`` defaults to
    NCCL, the card's transport; pass ``"gloo"`` for host tensors.  Under
    NCCL the rank's card is ``cuda:LOCAL_RANK``.  A failed initialisation
    raises.
    """
    env = os.environ
    if init_method is None:
        if "MASTER_ADDR" not in env:
            return False
        init_method = "env://"
    world_size = world_size if world_size is not None else int(env.get("WORLD_SIZE", "1"))
    rank = rank if rank is not None else int(env.get("RANK", "0"))
    backend = backend or "nccl"
    if backend == "nccl":
        _cuda.require_cuda("cuda")
        torch.cuda.set_device(int(env.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    return True


@dataclass(eq=False)
class Mesh:
    """One ``poly`` group as this rank sees it."""

    group: object  # a dist.ProcessGroup
    ranks: Tuple[int, ...]  # the group's global ranks, in shard order
    device: torch.device
    backend: str

    @property
    def D(self) -> int:
        return len(self.ranks)

    @property
    def d(self) -> int:
        return self.ranks.index(dist.get_rank())

    @property
    def staged(self) -> bool:
        """True when exchanged tensors cross through host memory."""
        return self.backend == "gloo" and self.device.type == "cuda"

    @property
    def transport(self) -> str:
        return f"{self.backend} (host-staged)" if self.staged else self.backend

    # -- collectives ----------------------------------------------------

    def _out(self, x: torch.Tensor) -> torch.Tensor:
        return x.contiguous().cpu() if self.staged else x.contiguous()

    def _back(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.device) if self.staged else x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(D, *x.shape): rank j's ``x`` at index j, on every rank."""
        src = self._out(x)
        outs = [torch.empty_like(src) for _ in range(self.D)]
        dist.all_gather(outs, src, group=self.group)
        return self._back(torch.stack(outs))

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x (D, ...): block j goes to rank j; returns (D, ...) with rank
        j's block for this rank at index j."""
        if x.shape[0] != self.D:
            raise ValueError(f"all_to_all: leading axis {x.shape[0]}, mesh of {self.D}")
        src = self._out(x)
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.group)
        return self._back(out)

    def exchange(self, x: torch.Tensor, dst: int, src: int) -> torch.Tensor:
        """Send ``x`` to group index ``dst`` and return what group index
        ``src`` sent here (same shape): one step of a permutation that
        every rank of the group takes together."""
        send = self._out(x)
        if dst == self.d and src == self.d:
            return self._back(send.clone())
        recv = torch.empty_like(send)
        ops = [
            dist.P2POp(dist.isend, send, self.ranks[dst], self.group),
            dist.P2POp(dist.irecv, recv, self.ranks[src], self.group),
        ]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return self._back(recv)


@dataclass(eq=False)
class Mesh2D:
    """A ``(data, poly)`` mesh: ``rows[r]`` is row r's poly group, or None
    on a rank outside it."""

    shape: Tuple[int, int]
    rows: List[Optional[Mesh]]
    device: torch.device


def _warm(mesh: Mesh) -> None:
    """One collective, so that a transport that cannot start raises here."""
    mesh.all_gather(torch.zeros(1, dtype=torch.int32, device=mesh.device))


def make_mesh(shape: Sequence[int] = (), axis_names: Sequence[str] = (), device="cuda"):
    """A mesh over the default process group (``init_distributed`` first).

    ``()`` or ``(W,)`` with ``("poly",)``: the 1-D poly mesh over the W
    ranks of the world.  ``(data, poly)`` with ``("data", "poly")``: row r
    takes global ranks (r*poly + j) mod W, j < poly, as its own subgroup;
    so at world size 1, ``(k, 1)`` gives k rows on this rank, each with its
    own size-1 group.  Raises if CUDA is asked for but absent, or if NCCL is
    asked to carry host tensors.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised (init_distributed)")
    dev = _cuda.require_cuda(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    backend = str(dist.get_backend())
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("an NCCL mesh carries CUDA tensors; use gloo for a CPU mesh")
    world = dist.get_world_size()
    shape = tuple(shape) or (world,)
    axis_names = tuple(axis_names) or (AXIS,)
    if len(shape) == 1:
        if axis_names != (AXIS,) or shape[0] != world:
            raise ValueError(f"a 1-D mesh is ({world},) over ('poly',), got {shape} {axis_names}")
        mesh = Mesh(dist.group.WORLD, tuple(range(world)), dev, backend)
        _warm(mesh)
        return mesh
    if axis_names != ("data", AXIS) or len(shape) != 2:
        raise ValueError(f"a 2-D mesh has axes ('data', 'poly'), got {axis_names}")
    data, poly = shape
    if world % poly or (data * poly) % world:
        raise ValueError(f"a ({data}, {poly}) mesh does not tile a world of {world}")
    me = dist.get_rank()
    rows = []
    for r in range(data):
        ranks = tuple((r * poly + j) % world for j in range(poly))
        group = dist.new_group(list(ranks), backend=backend)  # every rank creates every group
        rows.append(Mesh(group, ranks, dev, backend) if me in ranks else None)
    for mesh in rows:
        if mesh is not None:
            _warm(mesh)
    return Mesh2D((data, poly), rows, dev)


def shard_rows(mesh: Mesh, x: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """This rank's contiguous block of ``x`` along ``axis``."""
    n = x.shape[axis]
    if n % mesh.D:
        raise ValueError(f"axis of {n} does not split over {mesh.D} ranks")
    m = n // mesh.D
    return x.narrow(axis, mesh.d * m, m)


def gather_rows(mesh: Mesh, x: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """The inverse of ``shard_rows``: every rank's block, concatenated."""
    return torch.cat(mesh.all_gather(x).unbind(0), dim=axis)
