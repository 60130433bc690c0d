"""The 5-round prover over a ``poly`` mesh (domain sharding).

Counterpart of ``zkt_plonk_tpu/parallel/prover.py``'s ``ShardedProver``.
Every polynomial's n axis is split in contiguous blocks over the mesh's
ranks; transforms, grand-product scans, rolls, evaluations, divisions and
MSM reductions are the collectives of ``parallel/ops.py``.

One process per rank (SPMD): every rank runs ``prove`` on the whole
composer and transcript, commits are replicated (window totals gathered,
then folded on each rank's host), so every rank draws the same challenges,
the same blinders from its own ``rng`` of the same seed, and returns the
same ``Proof``, byte-equal to ``Prover.prove``'s.

The host side of the proof (``RoundSchedule.prove``) and the pointwise
arithmetic of rounds 3 and 4 (``grand_products``, ``quotient_evals``) are
the single-device prover's own, run on ``ShardedRows``; this module gives
the transforms, the quotient's split and the openings on shards, with the
collectives where the JAX sharded rounds put them.  Committed polynomials
are ``BodyTail`` batches: the n coefficients sharded (B, m, L), the
4-coefficient blinding tail replicated (B, 4, L) (wraparound blinding adds
b(X)(X^n - 1): +b at rows n..n+3, -b at rows 0..3).  Each round's
polynomials are committed as one batch.
"""

from __future__ import annotations

from typing import List

import torch

from ..fields import device as fd
from ..ops import msm as msm_mod
from ..proof_system.prover import PK_NAMES, RoundSchedule, grand_products, quotient_evals
from ..utils.profiling import section
from ..utils.scan import tree_reduce
from . import ops as pops
from .mesh import Mesh, shard_rows


class BodyTail:
    """A batch of committed polynomials on a mesh: ``body`` (B, m, L), this
    rank's block of the n coefficients, and ``tail`` (B, 4, L), the
    coefficients n..n+3, replicated.  Indexing takes polynomials along B, as
    a (B, n+4, L) tensor's does."""

    __slots__ = ("body", "tail")

    def __init__(self, body: torch.Tensor, tail: torch.Tensor):
        self.body = body
        self.tail = tail

    def __getitem__(self, i) -> "BodyTail":
        return BodyTail(self.body[i], self.tail[i])

    @staticmethod
    def stack(items) -> "BodyTail":
        return BodyTail(torch.stack([x.body for x in items]), torch.stack([x.tail for x in items]))


class ShardedRows:
    """``LocalRows``'s operations on ``mesh``'s row blocks (axis -2)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.holds_row0 = mesh.d == 0

    def roll(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        return pops.proll(x, shift, self.mesh)

    def batch_inverse(self, spec, x: torch.Tensor) -> torch.Tensor:
        return pops.pbatch_inverse(spec, x, x.dim() - 2, self.mesh)

    def prefix_products(self, spec, x: torch.Tensor) -> torch.Tensor:
        return pops.pprefix_products(spec, x, x.dim() - 2, self.mesh)


class ShardedProver(RoundSchedule):
    """Proves for a single-device ``Prover``'s circuit over ``mesh``.

    ``prover``'s keys and tables (on the mesh's device) are read as
    shards; nothing is copied at D = 1.  KZG keys only (the IPA opening is
    host Python on the whole polynomial).
    """

    stack = staticmethod(BodyTail.stack)

    def __init__(self, prover, mesh: Mesh):
        if prover.scheme.name != "kzg":
            raise TypeError(f"ShardedProver commits with KZG keys, got {prover.scheme.name}")
        if prover.device != mesh.device:
            raise ValueError(f"prover on {prover.device}, mesh on {mesh.device}")
        self.prover = prover
        self.mesh = mesh
        n = prover.n
        self.m = n // mesh.D
        if self.m < 8:
            raise ValueError(f"n = {n} over {mesh.D} ranks: the quotient split needs 8 rows per rank")
        self.n, self.p, self.spec, self.domain = n, prover.p, prover.spec, prover.domain
        self.device, self.epk, self.t_ints = mesh.device, prover.epk, prover.t_ints
        self.row_block = (mesh.d * self.m, (mesh.d + 1) * self.m)
        self.row_ops = ShardedRows(mesh)
        self.st = pops.build_shard_ntt_tables(prover.domain, mesh)
        self.msm_c = msm_mod.msm_window_size(n + 4)
        epk = prover.epk
        sh = lambda t: shard_rows(mesh, t)
        self.coset = {k: sh(v) for k, v in epk.coset.items()}
        self.x_coset = sh(epk.x_coset)
        self.l1_coset = sh(epk.l1_coset)
        self.sigma_evals = sh(epk.sigma_evals)
        self.roots = sh(epk.roots)
        self.pow4 = sh(prover.q4.pow4)
        self.ipow4 = sh(prover.q4.ipow4)
        self.t_dev = sh(prover.t_dev)
        powers = prover.ck.msm_points
        self.powers_body = powers._replace(points=shard_rows(mesh, powers.points[:n], axis=0))
        self.powers_tail = powers._replace(points=powers.points[n : n + 4])
        self.zero_tail = fd.zeros(prover.spec, (4,), device=mesh.device)
        self.pk_padded = {name: BodyTail(sh(prover.pk.polys[name]), self.zero_tail)
                          for name in PK_NAMES}

    # ------------------------------------------------------------------
    # device rounds
    # ------------------------------------------------------------------

    def commit_batch(self, evals: torch.Tensor, blinders: torch.Tensor) -> BodyTail:
        """Sharded iNTT of a (B, m, L) batch plus the blinding terms: body
        (B, m, L), tail = blinders (B, 4, L)."""
        spec = self.spec
        coeffs = pops.pifft(spec, self.st, evals, self.mesh)
        if self.mesh.d == 0:
            coeffs[..., :4, :] = fd.sub(spec, coeffs[..., :4, :], blinders)
        return BodyTail(coeffs, blinders)

    def z_round(self, wires, f, t, h1, h2, scalars, blinders) -> BodyTail:
        """Grand products z1 and z2 (``Prover.z_round``), committed form."""
        z_evals = grand_products(self.spec, self.row_ops, wires, f, t, h1, h2,
                                 self.roots, self.sigma_evals, scalars)
        return self.commit_batch(z_evals, blinders)

    def quotient_round(self, polys8: BodyTail, pi_evals, sc, weights, qblinders) -> BodyTail:
        """``Prover.quotient_round`` on shards.  polys8: bodies (8, m, L) and
        tails (8, 4, L) of [a,b,c,z1,z2,t,h1,h2]; pi_evals (m, L).  Returns
        q_lo, q_mid, q_hi."""
        prover, mesh, st = self.prover, self.mesh, self.st
        spec, q4 = prover.spec, prover.q4
        m = self.m
        pi_body = pops.pifft(spec, st, pi_evals, mesh)
        body9 = torch.cat([polys8.body, pi_body[None]])  # (9, m, L)
        tail9 = torch.cat([polys8.tail, self.zero_tail[None]])  # (9, 4, L)

        # the interleaved 4n-coset transform (``ntt.coset4_fft``), the tail
        # folded into global rows 0..3 on rank 0
        head4 = body9.unsqueeze(-3).expand(9, 4, m, spec.n_limbs)
        if mesh.d == 0:
            folded = fd.add(spec, head4[..., :4, :], fd.mul(spec, q4.gn4[:, None, :], tail9.unsqueeze(-3)))
            head4 = torch.cat([folded, head4[..., 4:, :]], dim=-2)
        cs = pops.pfft(spec, st, fd.mul(spec, head4, self.pow4), mesh)  # (9, 4, m, L)
        del head4
        q_evals = quotient_evals(spec, self.row_ops, cs, self.coset, self.x_coset, self.l1_coset,
                                 prover.epk.zh_coset_inv, sc, weights)
        del cs

        # ``ntt.coset4_ifft`` on shards: row t holds the shard of q[tn:(t+1)n]
        v = fd.mul(spec, pops.pifft(spec, st, q_evals, mesh), self.ipow4)  # (4j, m, L)
        terms = fd.mul(spec, v.unsqueeze(-4), q4.mix[:, :, None, :])  # (4t, 4j, m, L)
        t0, t1, t2, t3 = (terms[..., j, :, :] for j in range(4))
        q0, q1, q2, q3 = fd.add(spec, fd.add(spec, t0, t1), fd.add(spec, t2, t3)).unbind(0)
        del terms, v

        # split q into q_lo/q_mid/q_hi of n+2 coefficients each plus the
        # boundary blinders (``prove.rs:287-300``): the rows past a body's
        # end come from the next row block's first rows, on rank 0
        b0, b1 = qblinders[0], qblinders[1]
        zrow = torch.zeros_like(b0)[None]
        first = mesh.all_gather(torch.cat([q1[:4], q2[:4], q3[:8]]))[0]
        q1_first4, q2_first4, q3_first8 = first[:4], first[4:8], first[8:]
        last = mesh.d == mesh.D - 1

        lo_tail = torch.cat([q1_first4[:2], b0[None], zrow])
        mid_body = pops.proll(q1, -2, mesh, axis=0)
        if last:
            mid_body[m - 2 :] = q2_first4[:2]
        if mesh.d == 0:
            mid_body[0] = fd.sub(spec, mid_body[0], b0)
        mid_tail = torch.cat([q2_first4[2:4], b1[None], zrow])
        hi_body = pops.proll(q2, -4, mesh, axis=0)
        if last:
            hi_body[m - 4 :] = q3_first8[:4]
        if mesh.d == 0:
            hi_body[0] = fd.sub(spec, hi_body[0], b1)
        hi_tail = q3_first8[4:8]
        return BodyTail(torch.stack([q0, mid_body, hi_body]),
                        torch.stack([lo_tail, mid_tail, hi_tail]))

    def evaluate(self, polys_xi: BodyTail, polys_wxi: BodyTail, xi: int, wxi: int):
        """Values of the two batches at xi and at omega*xi, replicated."""
        spec, mesh = self.spec, self.mesh
        return (pops.peval_many(spec, polys_xi.body, polys_xi.tail, self.vec([xi])[0], mesh),
                pops.peval_many(spec, polys_wxi.body, polys_wxi.tail, self.vec([wxi])[0], mesh))

    def linearize(self, polys: BodyTail, scalars: torch.Tensor) -> BodyTail:
        spec = self.spec
        add = lambda a, b: fd.add(spec, a, b)
        s = scalars[:, None, :]
        return BodyTail(tree_reduce(add, fd.mul(spec, polys.body, s), 0),
                        tree_reduce(add, fd.mul(spec, polys.tail, s), 0))

    def open_batch(self, polys: BodyTail, point: int, eta: int) -> BodyTail:
        """eta-fold the batch and divide by (X - point): the KZG witness."""
        spec, p, vec = self.spec, self.p, self.vec
        add = lambda a, b: fd.add(spec, a, b)
        eta_powers = vec([pow(eta, i, p) for i in range(polys.body.shape[0])])[:, None, :]
        fb = tree_reduce(add, fd.mul(spec, polys.body, eta_powers), 0)
        ft = tree_reduce(add, fd.mul(spec, polys.tail, eta_powers), 0)
        return BodyTail(*pops.pdivide_by_linear(spec, fb, ft, vec([point])[0],
                                                vec([pow(point, -1, p)])[0], self.mesh))

    def openings(self, aw_polys: BodyTail, xi: int, saw_polys: BodyTail, wxi: int, eta: int):
        """Both KZG witnesses, committed as one batch."""
        witnesses = BodyTail.stack([self.open_batch(aw_polys, xi, eta),
                                    self.open_batch(saw_polys, wxi, eta)])
        aw_aff, saw_aff = self.commit_many(witnesses)
        return aw_aff, saw_aff

    def commit_many(self, polys: BodyTail) -> List:
        """One batched sharded MSM over the batch; host affine points, the
        same on every rank."""
        prover = self.prover
        ctx = prover.ctx
        with section("commit"):
            with section("msm"):
                totals = pops.pcommit_totals(
                    ctx.fq_spec, prover.ck.b3, self.powers_body, self.powers_tail, polys.body,
                    polys.tail, ctx.curve.fr.modulus.bit_length(), self.msm_c, self.mesh,
                )
            return msm_mod.fold_rows(ctx, totals, self.msm_c)
