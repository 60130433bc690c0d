"""k independent proofs over a ``(data, poly)`` mesh.

Counterpart of ``zkt_plonk_tpu/parallel/batch.py`` (``BASELINE.json``
config #5): a queue of witnesses (withdraw proofs, say) proved at once, each
row of the mesh a ``ShardedProver`` over its own poly group; proof i runs
on row ``i % data``.  Rows on one rank run in host threads, as in the JAX
package, each on its own CUDA stream, so one row's device work can overlap
another's host work; rows on other ranks run there, and every rank returns
every proof, in input order.

On one card at world size 1, ``make_mesh((k, 1), ("data", "poly"))`` gives
k rows that share the device, each with its own size-1 group.  The statics
they share (SRS powers, key tables, NTT plans) are the single-device
prover's, built before the threads start.
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence

import torch
import torch.distributed as dist

from ..utils import profiling
from .mesh import Mesh2D
from .prover import ShardedProver


class BatchProver:
    """k proofs over ``mesh2d``'s rows (``make_mesh((data, poly), ("data", "poly"))``)."""

    def __init__(self, prover, mesh2d: Mesh2D):
        if not isinstance(mesh2d, Mesh2D):
            raise TypeError("BatchProver takes a (data, poly) mesh of make_mesh")
        self.data = mesh2d.shape[0]
        self.rows = {r: ShardedProver(prover, row)
                     for r, row in enumerate(mesh2d.rows) if row is not None}
        cuda = mesh2d.device.type == "cuda"
        self.streams = {r: torch.cuda.Stream(mesh2d.device) if cuda else None for r in self.rows}
        self.device = mesh2d.device

    def prove_batch(self, composers: Sequence, transcripts: Sequence, rngs: Sequence) -> List:
        """Prove k witnesses; each (composer, transcript, rng) triple is an
        independent proof with its own Fiat-Shamir flow."""
        if not len(composers) == len(transcripts) == len(rngs):
            raise ValueError("need one transcript and one rng per composer")
        k = len(composers)

        def run_row(r):
            stream = self.streams[r]
            with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
                out = {i: self.rows[r].prove(composers[i], transcripts[i], rngs[i])
                       for i in range(r, k, self.data)}
            if stream is not None:
                with profiling.waiting():
                    stream.synchronize()
            return out

        if self.device.type == "cuda":
            # the rows read tensors the current stream built
            current = torch.cuda.current_stream(self.device)
            for stream in self.streams.values():
                stream.wait_stream(current)
        done = {}
        with ThreadPoolExecutor(max_workers=len(self.rows)) as pool:
            for fut in [pool.submit(run_row, r) for r in self.rows]:
                done.update(fut.result())
        if len(self.rows) < self.data:  # some rows run on other ranks
            gathered = [None] * dist.get_world_size()
            dist.all_gather_object(gathered, done)
            for part in gathered:
                done.update(part)
        return [done[i] for i in range(k)]
