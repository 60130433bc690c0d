"""Sharded primitives: the transforms, scans, shifts, evaluations and MSM
reductions of a domain-sharded polynomial.

Counterpart of ``zkt_plonk_tpu/parallel/ops.py``.  Every function keeps its
JAX name and global meaning; it takes this rank's LOCAL shard (a contiguous
block of the n axis, ``mesh.d`` of ``mesh.D``) and the ``Mesh`` in place of
``axis_name``, and every exchange goes through ``Mesh.all_gather`` /
``all_to_all`` / ``exchange``.  Field arithmetic is ``fields/device.py``
(kernels K1, K2 on the card), the MSM ``ops/msm.py`` (K4a, K4).

Sharded NTT (replaces ark-poly's Radix2 FFT, ``plonk-core/src/util.rs:
63-140``, at scale).  Over n = D*m elements the DIT bit reversal factors
into one all-to-all and a local gather: after the all-to-all, local index j
on rank d holds the global element j*D + rev_D(d), a natural-order stride-D
subsequence.  The first log2 m butterfly stages of the radix-2 transform
are then exactly the m-point NTT of that subsequence on the subgroup
generated by w^D, which is ``make_domain(fr, m)``'s own: the port runs it
as K3's fused passes on an m-point plan, reading natural order, so the
transform path skips ``pbitrev``'s final local gather.  The last log2 D
stages pair whole shards: one ``exchange`` with the partner rank and one
K1 multiply and add or subtract per stage.  Communication per transform:
(1 + log2 D) shard volumes.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..fields import device as fd
from ..fields.limbs import FieldSpec
from ..ops import msm as msm_mod
from ..ops import ntt
from ..ops import ec
from ..utils.domain import make_domain
from ..utils.scan import scan, tree_reduce
from .mesh import Mesh


class ShardNttTables(NamedTuple):
    """This rank's tables for a size-n NTT sharded over the mesh."""

    plan: ntt.NttPlan  # the m-point plan of the local stages (K3)
    rev_d: torch.Tensor  # (D,) int64 — log2(D)-bit reversal (an involution)
    rev_m: torch.Tensor  # (m,) int64 — the local m-point bit reversal
    tw: Tuple[torch.Tensor, ...]  # per global stage: this rank's (m, L) twiddles
    tw_inv: Tuple[torch.Tensor, ...]
    d_inv: torch.Tensor  # (L,) 1/D: the local inverse transforms scale by 1/m
    coset_pow: torch.Tensor  # (m, L) g^i over this rank's block
    coset_ipow: torch.Tensor  # (m, L) g^-i


def _rev(k: int, bits: int) -> int:
    out = 0
    for b in range(bits):
        out |= ((k >> b) & 1) << (bits - 1 - b)
    return out


def _geometric(spec: FieldSpec, first: int, ratio: int, count: int, device) -> torch.Tensor:
    """(count, L) limbs of first * ratio^i, computed on ``device``."""
    const = lambda v: fd.constant(spec, v, device=device)
    return fd.mul(spec, fd.powers(spec, const(ratio), count), const(first))


def build_shard_ntt_tables(domain, mesh: Mesh) -> ShardNttTables:
    """Tables of ``domain`` split over ``mesh``, for this rank, on its device."""
    n, D, d = domain.size, mesh.D, mesh.d
    if n % D or D & (D - 1):
        raise ValueError(f"need a power-of-two mesh dividing n = {n}, got D = {D}")
    m = n // D
    if m < 2:
        raise ValueError("each rank needs at least two rows")
    dev = mesh.device
    spec = domain.spec
    p = spec.modulus
    log_d = D.bit_length() - 1
    tw, tw_inv = [], []
    for s_g in range(log_d):
        hb = 1 << s_g
        stride = D // (2 * hb)
        first = (d & (hb - 1)) * m * stride  # twiddle index ((d & (hb-1)) m + r) * stride
        for w, out in ((domain.group_gen, tw), (domain.group_gen_inv, tw_inv)):
            out.append(_geometric(spec, pow(w, first, p), pow(w, stride, p), m, dev))
    ar = lambda vals: torch.tensor(vals, dtype=torch.int64, device=dev)
    g, gi = domain.coset_gen, domain.coset_gen_inv
    return ShardNttTables(
        plan=make_domain(domain.spec.params, m).plan(dev),
        rev_d=ar([_rev(j, log_d) for j in range(D)]),
        rev_m=ar([_rev(j, m.bit_length() - 1) for j in range(m)]),
        tw=tuple(tw),
        tw_inv=tuple(tw_inv),
        d_inv=fd.constant(spec, pow(D, -1, p), device=dev),
        coset_pow=_geometric(spec, pow(g, d * m, p), g, m, dev),
        coset_ipow=_geometric(spec, pow(gi, d * m, p), gi, m, dev),
    )


# ---------------------------------------------------------------------------
# sharded bit reversal + transforms
# ---------------------------------------------------------------------------


def _bitrev_exchange(x: torch.Tensor, rev_d: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The all-to-all half of ``pbitrev``: local index j then holds the
    global element j*D + rev_D(d)."""
    D = mesh.D
    if D == 1:
        return x
    m, L = x.shape[-2], x.shape[-1]
    lead = x.shape[:-2]
    # column c of the (m/D, D) view goes to rank rev_d[c]
    cols = x.reshape(*lead, m // D, D, L).index_select(-2, rev_d)
    recv = mesh.all_to_all(cols.movedim(-2, 0))  # (D, ..., m/D, L)
    # recv[a, ..., b] = rank a's x[b*D + rev_d[d]]
    return recv.movedim(0, -3).reshape(*lead, m, L)


def pbitrev(x: torch.Tensor, rev_d: torch.Tensor, rev_m: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Global bit-reversal permutation of a block-sharded poly axis: the
    local shard of x_global[bitrev(i)].  One all-to-all and two local
    gathers."""
    return _bitrev_exchange(x, rev_d, mesh).index_select(-2, rev_m)


def _global_stages(spec: FieldSpec, x: torch.Tensor, tws, mesh: Mesh) -> torch.Tensor:
    """The last log2(D) butterfly stages: whole-shard exchanges."""
    d = mesh.d
    for s_g, tw in enumerate(tws):
        hb = 1 << s_g
        other = mesh.exchange(x, d ^ hb, d ^ hb)
        if d & hb == 0:  # lower half: u = x, v = other
            x = fd.add(spec, x, fd.mul(spec, tw, other))
        else:  # upper half: u = other, v = x
            x = fd.sub(spec, other, fd.mul(spec, tw, x))
    return x


def pfft(spec: FieldSpec, st: ShardNttTables, coeffs: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sharded coefficients -> sharded natural-order evaluations."""
    x = ntt.fft(spec, st.plan, _bitrev_exchange(coeffs, st.rev_d, mesh))
    return _global_stages(spec, x, st.tw, mesh)


def pifft(spec: FieldSpec, st: ShardNttTables, evals: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sharded natural-order evaluations -> sharded coefficients."""
    x = ntt.ifft(spec, st.plan, _bitrev_exchange(evals, st.rev_d, mesh))
    x = _global_stages(spec, x, st.tw_inv, mesh)
    return x if mesh.D == 1 else fd.mul(spec, x, st.d_inv)


def pcoset_fft(spec: FieldSpec, st: ShardNttTables, coeffs: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return pfft(spec, st, fd.mul(spec, coeffs, st.coset_pow), mesh)


def pcoset_ifft(spec: FieldSpec, st: ShardNttTables, evals: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return fd.mul(spec, pifft(spec, st, evals, mesh), st.coset_ipow)


# ---------------------------------------------------------------------------
# sharded scans / rolls
# ---------------------------------------------------------------------------


def proll(x: torch.Tensor, shift: int, mesh: Mesh, axis: int = -2) -> torch.Tensor:
    """Global roll by a small ``shift`` along a block-sharded axis: a local
    roll and one exchange of the |shift| boundary rows."""
    D, d = mesh.D, mesh.d
    k = abs(shift)
    m = x.shape[axis]
    if k > m:
        raise ValueError("roll distance must fit in one shard")
    rolled = torch.roll(x, shift, dims=axis)
    if D == 1 or k == 0:
        return rolled
    if shift < 0:
        # my leading k rows become the trailing k rows of rank d-1
        recv = mesh.exchange(x.narrow(axis, 0, k), (d - 1) % D, (d + 1) % D)
        rolled.narrow(axis, m - k, k).copy_(recv)
    else:
        recv = mesh.exchange(x.narrow(axis, m - k, k), (d + 1) % D, (d - 1) % D)
        rolled.narrow(axis, 0, k).copy_(recv)
    return rolled


def pprefix_products(spec: FieldSpec, x: torch.Tensor, axis: int, mesh: Mesh) -> torch.Tensor:
    """Global inclusive prefix products along a block-sharded axis: a local
    log-depth scan, an all-gather of the D shard totals and a D-element scan
    of them, replicated."""
    axis = axis % x.dim()
    local = fd.prefix_products(spec, x, axis=axis)
    if mesh.D == 1:
        return local
    m = x.shape[axis]
    totals = mesh.all_gather(local.select(axis, m - 1))  # (D, ..., L)
    if mesh.d == 0:
        return local
    before = fd.prefix_products(spec, totals[: mesh.d], axis=0)[-1]
    return fd.mul(spec, local, before.unsqueeze(axis))


def pflip(x: torch.Tensor, axis: int, mesh: Mesh) -> torch.Tensor:
    """Global flip along a block-sharded axis: a local flip and the reversal
    of the rank order (one exchange)."""
    loc = torch.flip(x, dims=(axis,))
    if mesh.D == 1:
        return loc
    partner = mesh.D - 1 - mesh.d
    return mesh.exchange(loc, partner, partner)


def pbatch_inverse(spec: FieldSpec, x: torch.Tensor, axis: int, mesh: Mesh) -> torch.Tensor:
    """Global Montgomery-trick batch inversion along a sharded axis (zeros
    map to zero): one Fermat inversion (kernel K2) of the global product."""
    if mesh.D == 1:
        return fd.batch_inverse(spec, x, axis=axis)
    axis = axis % x.dim()
    zero_mask = fd.is_zero(spec, x)
    safe = torch.where(zero_mask.unsqueeze(-1), fd.one(spec, (), device=x.device), x)

    incl_pre = pprefix_products(spec, safe, axis, mesh)
    incl_suf = pflip(pprefix_products(spec, pflip(safe, axis, mesh), axis, mesh), axis, mesh)
    m = x.shape[axis]
    # the global product is the last rank's inclusive prefix total
    total = mesh.all_gather(incl_pre.select(axis, m - 1))[-1]
    total_inv = fd.inv(spec, total)

    ones_row = fd.one(spec, (), device=x.device)
    pre_excl = _shift_one(incl_pre, 1, axis, mesh, ones_row)
    suf_excl = _shift_one(incl_suf, -1, axis, mesh, ones_row)
    out = fd.mul(spec, fd.mul(spec, pre_excl, suf_excl), total_inv.unsqueeze(axis))
    return torch.where(zero_mask.unsqueeze(-1), torch.zeros_like(x), out)


def _shift_one(arr: torch.Tensor, shift: int, axis: int, mesh: Mesh, fill_row) -> torch.Tensor:
    """Global shift by +-1 along the sharded axis, the vacated global
    boundary row set to ``fill_row`` (no wraparound)."""
    out = proll(arr, shift, mesh, axis=axis)
    m = arr.shape[axis]
    if shift > 0 and mesh.d == 0:
        out.narrow(axis, 0, shift).copy_(fill_row.expand_as(out.narrow(axis, 0, shift)))
    elif shift < 0 and mesh.d == mesh.D - 1:
        out.narrow(axis, m + shift, -shift).copy_(fill_row.expand_as(out.narrow(axis, m + shift, -shift)))
    return out


# ---------------------------------------------------------------------------
# sharded polynomial evaluation / synthetic division (round 5 + openings)
# ---------------------------------------------------------------------------


def pshard_powers(spec: FieldSpec, x: torch.Tensor, m: int, mesh: Mesh):
    """(x^(d*m + j))_{j<m} for this rank d, and x^n (n = D*m), replicated.

    x: an (L,) scalar.  Returns (local powers (m, L), x^n (L,)).
    """
    base = fd.powers(spec, x, m)  # the same on every rank
    cur = fd.mul(spec, base[m - 1], x)  # x^m
    fac = None  # x^(m*d) by the bits of d
    b = 0
    while (1 << b) < mesh.D:
        if (mesh.d >> b) & 1:
            fac = cur if fac is None else fd.mul(spec, fac, cur)
        cur = fd.mul(spec, cur, cur)
        b += 1
    return (base if fac is None else fd.mul(spec, base, fac)), cur


def _tail_powers(spec: FieldSpec, x: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """(4, L) = x^n .. x^(n+3)."""
    return fd.mul(spec, fd.powers(spec, x, 4), xn)


def peval_many(spec: FieldSpec, bodies: torch.Tensor, tails: torch.Tensor, x: torch.Tensor,
               mesh: Mesh) -> torch.Tensor:
    """Evaluate committed (body shard, replicated tail) polys at scalar x.

    bodies: (B, m, L) shard of the n coefficient rows; tails: (B, 4, L)
    rows n..n+3, replicated.  Returns (B, L), replicated.
    """
    m = bodies.shape[-2]
    add = lambda a, b: fd.add(spec, a, b)
    local_powers, xn = pshard_powers(spec, x, m, mesh)
    partial = tree_reduce(add, fd.mul(spec, bodies, local_powers), -2)  # (B, L)
    body_sum = tree_reduce(add, mesh.all_gather(partial), 0)
    tail_sum = tree_reduce(add, fd.mul(spec, tails, _tail_powers(spec, x, xn)), -2)
    return fd.add(spec, body_sum, tail_sum)


def pdivide_by_linear(spec: FieldSpec, body: torch.Tensor, tail: torch.Tensor, x: torch.Tensor,
                      x_inv: torch.Tensor, mesh: Mesh):
    """(P(X) - P(x)) / (X - x) for a committed (body, tail) polynomial.

    Sharded ``kzg.divide_by_linear``: q_i = x^-(i+1) * sum_{j>i} c_j x^j
    over the global n+4 coefficient axis.  The cross-shard part of a body
    row's suffix is a per-rank offset (an all-gather of the D shard totals)
    plus the replicated tail's total: no body rows move.

    body: (m, L) shard; tail: (4, L) replicated.  Returns (q body (m, L)
    shard, q tail (4, L) replicated).
    """
    D, d = mesh.D, mesh.d
    m = body.shape[-2]
    zero = fd.zeros(spec, (1,), device=body.device)
    add = lambda a, b: fd.add(spec, a, b)

    pow_x, xn = pshard_powers(spec, x, m, mesh)
    local_suf = scan(add, fd.mul(spec, body, pow_x), 0, reverse=True)  # (m, L)
    tail_suf = scan(add, fd.mul(spec, tail, _tail_powers(spec, x, xn)), 0, reverse=True)  # (4, L)

    # offset_d = the totals of the shards after d
    gathered = mesh.all_gather(local_suf[0])  # (D, L)
    offset = tree_reduce(add, gathered[d + 1:], 0) if d + 1 < D else zero[0]
    excl = torch.cat([local_suf[1:], zero])
    excl = fd.add(spec, excl, fd.add(spec, offset, tail_suf[0]))

    # x^-(dm+j+1) = x_inv^(dm+j) * x_inv
    pow_xi, xin = pshard_powers(spec, x_inv, m, mesh)
    q_body = fd.mul(spec, fd.mul(spec, excl, pow_xi), x_inv)
    # tail rows (global n..n+3): x^-(n+j+1) = x_inv^n * x_inv^(j+1)
    tail_excl = torch.cat([tail_suf[1:], zero])
    q_tail = fd.mul(spec, tail_excl, fd.mul(spec, _tail_powers(spec, x_inv, xin), x_inv))
    return q_body, q_tail


# ---------------------------------------------------------------------------
# sharded MSM
# ---------------------------------------------------------------------------


def pmsm_totals(fq_spec, b3, points, scalars, fr_bits: int, mesh: Mesh, c: int = 0,
                groups: int = 0) -> torch.Tensor:
    """Sharded Pippenger up to the per-window totals ((B,) W, 3, L),
    replicated: each rank accumulates its point shard (K4a; an
    ``msm.CommitPoints``) and reduces its buckets, then the small per-rank
    window totals are all-gathered and summed with log2(D) rounds of K4
    adds."""
    tot = msm_mod.msm_totals(fq_spec, b3, points, scalars, fr_bits, c=c, groups=groups)
    if mesh.D == 1:
        return tot
    return tree_reduce(lambda a, b: ec.add(fq_spec, b3, a, b), mesh.all_gather(tot), 0)


def pcommit_totals(fq_spec, b3, powers_shard, tail_points, coeffs_shard, tail_coeffs,
                   fr_bits: int, c: int, mesh: Mesh, groups: int = 0) -> torch.Tensor:
    """Window totals of an MSM over (n sharded + 4 replicated-tail) rows.

    The prover commits (n+4)-coefficient polynomials: the n-part sharded,
    the 4-row tail replicated.  The tail rides each rank's accumulation, its
    coefficients zero except on rank 0 (zero digits land in the bucket that
    is never weighted).  ``c`` must be the window size of the host fold
    (``msm.msm_window_size(n + 4)`` of the global n), so that window totals
    align across ranks.  coeffs (B, m, L) with tails (B, 4, L), or unbatched.
    The points are two ``msm.CommitPoints`` of one key's copy.
    """
    points = msm_mod.CommitPoints(torch.cat([msm_mod.z1_points(powers_shard),
                                             msm_mod.z1_points(tail_points)]))
    tc = tail_coeffs if mesh.d == 0 else torch.zeros_like(tail_coeffs)
    scalars = torch.cat([coeffs_shard, tc], dim=-2)
    return pmsm_totals(fq_spec, b3, points, scalars, fr_bits, mesh, c=c, groups=groups)
