"""KZG10 polynomial commitments — device commits, host checks.

Role of the reference's ``KZG10 = SonicKZG10`` (``plonk-core/src/
commitment.rs:24-46``), as in ``zkt_plonk_tpu/commitment/kzg.py``:

* ``setup``/``trim``: SRS powers [tau^i]G1 — a host windowed fixed-base
  MSM up to 4096 points, above that ``ops/msm.fixed_base_msm`` on the device
  (the host computes only the scalar powers);
* ``Committer.commit_many``: the port's Pippenger MSM on the device the
  polynomials live on (no host route), over the key's ``msm_points``;
* ``divide_by_linear``: the opening witness (P(X) - P(xi)) / (X - xi) as a
  multiply, a log-depth suffix sum and a multiply;
* ``check``: the host pairing equation.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _cuda
from ..curves import curve_host as ch, pairing as pairing_mod
from ..curves.context import CurveCtx
from ..fields import device as fd
from ..fields.limbs import ints_to_array
from ..ops import ec, msm
from ..utils.profiling import section
from ..utils.scan import scan


@dataclass(eq=False)
class CommitterKey:
    """SRS G1 powers on device: (N, 3, L) projective, plus curve constants."""

    ctx: CurveCtx
    powers: torch.Tensor  # (N, 3, L)
    b3: ec.B3  # the curve constant 3b

    @property
    def max_degree(self) -> int:
        return self.powers.shape[0] - 1

    @property
    def device(self) -> torch.device:
        return self.powers.device

    @cached_property
    def msm_points(self) -> msm.CommitPoints:
        """The powers as commits take them (``msm.commit_points``: a Z = 1
        copy), built on first use and shared by every committer of this
        key; derived state, never serialized."""
        return msm.commit_points(self.ctx.fq_spec, self.powers)


@dataclass(eq=False)
class VerifierKeyKZG:
    """Host-side verification elements."""

    ctx: CurveCtx
    g1: Tuple  # G1 generator (affine host)
    g2: Tuple  # G2 generator
    tau_g2: Tuple  # [tau] G2


def setup(
    ctx: CurveCtx, max_degree: int, tau: Optional[int] = None, rng=None, device="cuda"
) -> Tuple[CommitterKey, VerifierKeyKZG]:
    """Generate a (testing) SRS on ``device``.  ``tau`` is sampled if not given."""
    dev = _cuda.require_cuda(device)
    r = ctx.curve.fr.modulus
    if tau is None:
        import secrets

        tau = (rng.randrange(r) if rng is not None else secrets.randbelow(r)) or 1

    powers_int = [1] * (max_degree + 1)
    for i in range(1, max_degree + 1):
        powers_int[i] = powers_int[i - 1] * tau % r

    fr_spec = ctx.fr_spec
    fq_spec = ctx.fq_spec
    b3 = ec.b3_const(fq_spec, ctx.curve.b, device=dev)
    if max_degree <= 4096:
        # small SRS: host windowed fixed-base MSM
        W = msm.num_windows(r.bit_length(), 8)
        base = ctx.g1
        table = []
        for _ in range(W):
            row = [None]
            for _ in range(255):
                row.append(ch.add(row[-1], base))
            table.append(row)
            for _ in range(8):
                base = ch.double(base)
        pts = []
        for s in powers_int:
            acc = None
            for w in range(W):
                d = (s >> (8 * w)) & 255
                if d:
                    acc = ch.add(acc, table[w][d])
            pts.append(acc)
        host = ec.from_affine_host(
            fq_spec, [None if a is None else (int(a[0]), int(a[1])) for a in pts]
        )
        powers = torch.from_numpy(host.astype(np.int32)).to(dev)
    else:
        tables = torch.from_numpy(msm.fixed_base_tables(ctx, ctx.g1, c=8).astype(np.int32)).to(dev)
        scalars = torch.from_numpy(ints_to_array(powers_int, fr_spec.n_limbs).astype(np.int32)).to(dev)
        powers = msm.fixed_base_msm(fq_spec, b3, tables, scalars, r.bit_length(), c=8)

    ck = CommitterKey(ctx=ctx, powers=powers, b3=b3)
    cvk = VerifierKeyKZG(ctx=ctx, g1=ctx.g1, g2=ctx.g2, tau_g2=ch.scalar_mul(ctx.g2, tau))
    return ck, cvk


def trim(ck: CommitterKey, cvk: VerifierKeyKZG, degree: int):
    assert ck.max_degree >= degree, (
        f"SRS supports degree {ck.max_degree}, circuit needs {degree} "
        f"(circuit_bound * 4) — regenerate with a larger max_degree"
    )
    return CommitterKey(ctx=ck.ctx, powers=ck.powers[: degree + 1], b3=ck.b3), cvk


class Committer:
    """Batched commitments: the port's MSM over the SRS, on the SRS's device."""

    def __init__(self, ck: CommitterKey):
        self.ck = ck

    def commit_many(self, polys) -> list:
        """polys: (B, m, L) tensor or list of (m, L).  Returns a list of host
        affine points.  All polys share one length (one window size)."""
        with section("commit"):
            return msm.commit_rows(self.ck.ctx, self.ck.b3, self.ck.msm_points, polys)


def divide_by_linear(
    fr_spec, coeffs: torch.Tensor, xi_powers: torch.Tensor, xi_inv_powers: torch.Tensor
) -> torch.Tensor:
    """(P(X) - P(xi)) / (X - xi): q_i = xi^{-(i+1)} * Σ_{j>i} c_j xi^j.

    xi_powers: (m, L) = [1, xi, ...]; xi_inv_powers: (m, L) = [xi^-1, xi^-2, ...].
    """
    u = fd.mul(fr_spec, coeffs, xi_powers)  # c_j xi^j
    suf = scan(lambda a, b: fd.add(fr_spec, a, b), u, 0, reverse=True)  # Σ_{j>=i} u_j
    suf_excl = torch.cat([suf[1:], fd.zeros(fr_spec, (1,), device=suf.device)], dim=0)
    return fd.mul(fr_spec, suf_excl, xi_inv_powers)


def check(
    cvk: VerifierKeyKZG,
    commitments: Sequence[Optional[Tuple[int, int]]],
    point: int,
    values: Sequence[int],
    proof_w: Optional[Tuple[int, int]],
    eta: int,
) -> bool:
    """Batched single-point KZG check:
    e(Σ eta^i C_i - (Σ eta^i v_i) G1 + xi W, H) == e(W, tau H).
    """
    ctx = cvk.ctx
    r = ctx.curve.fr.modulus
    Fq = ctx.Fq

    def to_pt(c):
        if c is None:
            return None
        return (Fq(c[0]), Fq(c[1]))

    acc = None
    v_agg = 0
    power = 1
    for c, v in zip(commitments, values):
        acc = ch.add(acc, ch.scalar_mul(to_pt(c), power))
        v_agg = (v_agg + power * v) % r
        power = power * eta % r

    lhs = ch.add(acc, ch.scalar_mul(ctx.g1, (-v_agg) % r))
    w = to_pt(proof_w)
    lhs = ch.add(lhs, ch.scalar_mul(w, point % r))
    return pairing_mod.pairing_product_is_one(
        ctx, [(lhs, cvk.g2), (ch.neg(w), cvk.tau_g2)]
    )
