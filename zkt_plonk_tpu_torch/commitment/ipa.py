"""Inner-product-argument polynomial commitment (pairing-free).

The second ``HomomorphicCommitment`` instance of the reference,
``IPA = InnerProductArgPC`` (``plonk-core/src/commitment.rs:49-86``), as in
``zkt_plonk_tpu/commitment/ipa.py``: the committer key is a vector of
independent curve generators obtained by hash-to-curve, a commit is an MSM
of the coefficients over them, and an opening is the log-round
Bulletproofs folding argument.

The key carries its generators twice: as host affine points (the opening
and the check are host Python, exactly as in the JAX package) and as a
(n, 3, L) projective limb tensor on ``device``, the table the port's
Pippenger MSM (``ops/msm.py``: kernels K4a and K4 on the card, their plain
versions on the CPU) commits over.

Challenges are Fiat-Shamir over a keccak256 sponge with fixed-width
big-endian encodings sized to the base field (so BLS12-381's 48-byte Fq
round-trips exactly).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _cuda
from ..curves import curve_host as ch
from ..curves.context import CurveCtx, make_context
from ..fields.limbs import ints_to_array
from ..ops import ec, msm
from ..transcript.keccak import keccak256

Affine = Optional[Tuple[object, object]]  # host affine point (Fq, Fq) or None


# ---------------------------------------------------------------------------
# deterministic generator derivation (hash-to-curve, try-and-increment)
# ---------------------------------------------------------------------------


def _sqrt_mod(a: int, p: int) -> Optional[int]:
    """Square root mod p (general: Tonelli-Shanks for p ≡ 1 mod 4, e.g.
    BLS12-377 Fq)."""
    from ..utils.arkserde import sqrt_mod

    return sqrt_mod(a, p)


def hash_to_point(ctx: CurveCtx, tag: bytes) -> Tuple[object, object]:
    """Map a byte tag to a prime-order-subgroup point with no known
    discrete log.

    Cofactor clearing is soundness-critical for the IPA: the u/u^-1
    folding computes inverses mod r, and (u * u^-1) P == P only holds for
    points of order r — an off-subgroup generator (cofactor > 1 on the
    BLS curves) breaks the verification identity.
    """
    p = ctx.curve.fq.modulus
    b = ctx.curve.b
    cofactor = ctx.curve.g1_cofactor
    nbytes = (p.bit_length() + 7) // 8
    ctr = 0
    while True:
        h = b"zkt-ipa-gen" + tag + ctr.to_bytes(4, "big")
        buf = b""
        blk = 0
        while len(buf) < nbytes + 16:
            buf += keccak256(h + blk.to_bytes(4, "big"))
            blk += 1
        x = int.from_bytes(buf[: nbytes + 16], "big") % p
        y = _sqrt_mod((x * x % p * x + b) % p, p)
        if y is not None:
            if y % 2:  # canonical choice: even y
                y = p - y
            pt = (ctx.Fq(x), ctx.Fq(y))
            if cofactor != 1:
                pt = ch.scalar_mul(pt, cofactor)
                if pt is None:  # landed on the identity; try again
                    ctr += 1
                    continue
            return pt
        ctr += 1


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------


@dataclass(eq=False)
class CommitterKeyIPA:
    """Generators for degree-bound commitments.

    ``gens[i]`` commits coefficient i; ``u`` carries the inner-product
    value (the reference's IPA committer key role, ``commitment.rs:56-63``).
    ``gens_dev`` holds the same generators as (n, 3, L) projective limbs on
    the key's device, and ``b3`` the curve constant for the MSM.
    """

    ctx: CurveCtx
    gens: List[Affine]
    u: Affine
    max_degree: int
    gens_dev: torch.Tensor
    b3: ec.B3

    @property
    def device(self) -> torch.device:
        return self.gens_dev.device

    @cached_property
    def msm_points(self) -> msm.CommitPoints:
        """``gens_dev`` as commits take them (``msm.commit_points``), built
        on first use and shared by every committer of this key.  The
        generators already have Z = 1, so the copy equals them bit for bit."""
        return msm.commit_points(self.ctx.fq_spec, self.gens_dev)

    def supported_degree(self) -> int:
        return len(self.gens) - 1


# verifier key is identical material (no trimming asymmetry needed here)
VerifierKeyIPA = CommitterKeyIPA


def make_key(ctx: CurveCtx, gens: List[Affine], u: Affine, device="cuda") -> CommitterKeyIPA:
    """A key from host generators, with their limb table on ``device``."""
    dev = _cuda.require_cuda(device)
    fq = ctx.fq_spec
    table = ec.from_affine_host(fq, [None if g is None else (int(g[0]), int(g[1])) for g in gens])
    return CommitterKeyIPA(
        ctx=ctx,
        gens=list(gens),
        u=u,
        max_degree=len(gens) - 1,
        gens_dev=torch.from_numpy(table.astype(np.int32)).to(dev),
        b3=ec.b3_const(fq, ctx.curve.b, device=dev),
    )


def setup(ctx_or_name, max_degree: int, device="cuda") -> Tuple[CommitterKeyIPA, CommitterKeyIPA]:
    """Derive `max_degree+1` independent generators (rounded up to a power
    of two) + the u generator; the MSM table goes to ``device``.

    Transparent setup (nothing-up-my-sleeve hashes) — no trusted tau.
    """
    _cuda.require_cuda(device)
    ctx = make_context(ctx_or_name) if isinstance(ctx_or_name, str) else ctx_or_name
    n = _next_pow2(max_degree + 1)
    gens = [hash_to_point(ctx, b"G%d" % i) for i in range(n)]
    u = hash_to_point(ctx, b"U")
    ck = make_key(ctx, gens, u, device=device)
    return ck, ck


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


# ---------------------------------------------------------------------------
# commit
# ---------------------------------------------------------------------------


def _host_msm(points: Sequence[Affine], scalars: Sequence[int]) -> Affine:
    return ch.msm(list(points), list(scalars))


def _device_commit(ck: CommitterKeyIPA, scalars: Sequence[int]) -> Affine:
    """The port's Pippenger MSM over the generator table (the key's
    ``msm_points``, as ``IPAScheme``'s committer commits), on the key's
    device."""
    ctx = ck.ctx
    r = ctx.curve.fr.modulus
    coeffs = ints_to_array([int(s) % r for s in scalars], ctx.fr_spec.n_limbs)
    coeffs = torch.from_numpy(coeffs.astype(np.int32)).to(ck.device)
    aff = msm.commit_rows(ctx, ck.b3, ck.msm_points, coeffs[None])[0]
    return None if aff is None else (ctx.Fq(aff[0]), ctx.Fq(aff[1]))


def commit(ck: CommitterKeyIPA, coeffs: Sequence[int], device: bool = False) -> Affine:
    """C = Σ coeffs[i] · G_i (non-hiding; PLONK blinds at the poly level).
    ``device=True`` runs the port's MSM on the key's device, else the naive
    host MSM."""
    if len(coeffs) > len(ck.gens):
        raise ValueError("polynomial degree exceeds committer key")
    if device:
        return _device_commit(ck, coeffs)
    return _host_msm(ck.gens[: len(coeffs)], coeffs)


# ---------------------------------------------------------------------------
# Fiat-Shamir challenger (fixed-width keccak sponge)
# ---------------------------------------------------------------------------


class _Challenger:
    def __init__(self, ctx: CurveCtx, label: bytes):
        self._ctx = ctx
        self._fq_bytes = (ctx.curve.fq.modulus.bit_length() + 7) // 8
        self._state = keccak256(b"zkt-ipa-transcript" + label)

    def absorb_scalar(self, v: int) -> None:
        self._state = keccak256(self._state + int(v).to_bytes(32, "big"))

    def absorb_point(self, pt: Affine) -> None:
        if pt is None:
            data = b"\x00" * (2 * self._fq_bytes)
        else:
            data = int(pt[0]).to_bytes(self._fq_bytes, "big") + int(
                pt[1]
            ).to_bytes(self._fq_bytes, "big")
        self._state = keccak256(self._state + data)

    def challenge(self) -> int:
        r = self._ctx.curve.fr.modulus
        out = keccak256(self._state + b"chal")
        self._state = keccak256(self._state + b"next")
        # uniform-enough: 256 bits reduced mod r (r is 254/255 bits)
        c = int.from_bytes(out, "big") % r
        return c if c != 0 else 1


# ---------------------------------------------------------------------------
# open / check
# ---------------------------------------------------------------------------


@dataclass
class IPAProof:
    """Log-round opening proof: cross terms per round + final scalar."""

    l_points: List[Tuple[int, int]]
    r_points: List[Tuple[int, int]]
    a_final: int

    def to_host(self):
        return self


def _fold_scalars(vec: List[int], u: int, u_inv: int, r: int) -> List[int]:
    half = len(vec) // 2
    return [(vec[i] * u + vec[half + i] * u_inv) % r for i in range(half)]


def open_poly(
    ck: CommitterKeyIPA,
    coeffs: Sequence[int],
    z: int,
    value: Optional[int] = None,
    label: bytes = b"",
) -> IPAProof:
    """Open `commit(coeffs)` at z: prove <a, (1,z,z²,…)> = P(z).

    Bulletproofs folding: per round send
      L = <a_lo, G_hi> + <a_lo, b_hi>·U',  R = <a_hi, G_lo> + <a_hi, b_lo>·U'
    and fold a' = a_lo·u + a_hi·u⁻¹, b' = b_lo·u⁻¹ + b_hi·u,
    G' = G_lo·u⁻¹ + G_hi·u.
    """
    ctx = ck.ctx
    r = ctx.curve.fr.modulus
    n = _next_pow2(len(coeffs))
    a = [int(c) % r for c in coeffs] + [0] * (n - len(coeffs))
    b = [pow(z, i, r) for i in range(n)]
    g = list(ck.gens[:n])
    if value is None:
        value = sum(ai * bi for ai, bi in zip(a, b)) % r

    chal = _Challenger(ctx, label)
    chal.absorb_scalar(z)
    chal.absorb_scalar(value)
    xi0 = chal.challenge()
    u_prime = ch.scalar_mul(ck.u, xi0)

    ls: List[Tuple[int, int]] = []
    rs: List[Tuple[int, int]] = []
    while len(a) > 1:
        half = len(a) // 2
        a_lo, a_hi = a[:half], a[half:]
        b_lo, b_hi = b[:half], b[half:]
        g_lo, g_hi = g[:half], g[half:]
        cl = sum(x * y for x, y in zip(a_lo, b_hi)) % r
        cr = sum(x * y for x, y in zip(a_hi, b_lo)) % r
        l_pt = ch.add(_host_msm(g_hi, a_lo), ch.scalar_mul(u_prime, cl))
        r_pt = ch.add(_host_msm(g_lo, a_hi), ch.scalar_mul(u_prime, cr))
        chal.absorb_point(l_pt)
        chal.absorb_point(r_pt)
        u = chal.challenge()
        u_inv = pow(u, r - 2, r)
        a = _fold_scalars(a, u, u_inv, r)
        b = _fold_scalars(b, u_inv, u, r)
        g = [
            ch.add(ch.scalar_mul(g[i], u_inv), ch.scalar_mul(g[half + i], u))
            for i in range(half)
        ]
        ls.append(None if l_pt is None else (int(l_pt[0]), int(l_pt[1])))
        rs.append(None if r_pt is None else (int(r_pt[0]), int(r_pt[1])))
    return IPAProof(l_points=ls, r_points=rs, a_final=a[0])


def check(
    ck: CommitterKeyIPA,
    commitment: Affine,
    z: int,
    value: int,
    proof: IPAProof,
    label: bytes = b"",
) -> bool:
    """Verify an opening: O(d) MSM + O(log d) point ops."""
    ctx = ck.ctx
    r = ctx.curve.fr.modulus
    k = len(proof.l_points)
    n = 1 << k

    chal = _Challenger(ctx, label)
    chal.absorb_scalar(z)
    chal.absorb_scalar(value % r)
    xi0 = chal.challenge()
    u_prime = ch.scalar_mul(ck.u, xi0)

    us: List[int] = []
    fq = ctx.Fq
    for l_pt, r_pt in zip(proof.l_points, proof.r_points):
        chal.absorb_point(None if l_pt is None else (fq(l_pt[0]), fq(l_pt[1])))
        chal.absorb_point(None if r_pt is None else (fq(r_pt[0]), fq(r_pt[1])))
        us.append(chal.challenge())

    # folded target: P' = C + v·U' + Σ u_j² L_j + u_j⁻² R_j
    acc = ch.add(commitment, ch.scalar_mul(u_prime, value % r))
    for u, l_pt, r_pt in zip(us, proof.l_points, proof.r_points):
        u_inv = pow(u, r - 2, r)
        lp = None if l_pt is None else (fq(l_pt[0]), fq(l_pt[1]))
        rp = None if r_pt is None else (fq(r_pt[0]), fq(r_pt[1]))
        acc = ch.add(acc, ch.scalar_mul(lp, u * u % r))
        acc = ch.add(acc, ch.scalar_mul(rp, u_inv * u_inv % r))

    # s_i = Π_j u_j^{±1} with challenge j selecting bit k-1-j of i
    s = [1]
    for u in reversed(us):
        u_inv = pow(u, r - 2, r)
        s = [x * u_inv % r for x in s] + [x * u % r for x in s]
    b0 = 0
    zp = 1
    for si in s:
        b0 = (b0 + si * zp) % r
        zp = zp * z % r
    g0 = _host_msm(ck.gens[:n], s)

    a0 = proof.a_final % r
    rhs = ch.add(ch.scalar_mul(g0, a0), ch.scalar_mul(u_prime, a0 * b0 % r))
    return _pt_eq(acc, rhs)


def _pt_eq(p1: Affine, p2: Affine) -> bool:
    if p1 is None or p2 is None:
        return p1 is None and p2 is None
    return int(p1[0]) == int(p2[0]) and int(p1[1]) == int(p2[1])


# ---------------------------------------------------------------------------
# batch opening (powers-of-challenge aggregation, commitment.rs:114-124)
# ---------------------------------------------------------------------------


def open_batch(
    ck: CommitterKeyIPA,
    polys: Sequence[Sequence[int]],
    z: int,
    eta: int,
    label: bytes = b"batch",
) -> Tuple[IPAProof, int]:
    """Aggregate polynomials with powers of eta, open the fold at z.

    Mirrors `aggregate_polynomials` (`commitment.rs:114-124`) + PC::open.
    Returns (proof, aggregated value).
    """
    r = ck.ctx.curve.fr.modulus
    m = max(len(p) for p in polys)
    agg = [0] * m
    power = 1
    for poly in polys:
        for i, c in enumerate(poly):
            agg[i] = (agg[i] + power * int(c)) % r
        power = power * eta % r
    v = _eval_poly(agg, z, r)
    return open_poly(ck, agg, z, v, label=label), v


def check_batch(
    ck: CommitterKeyIPA,
    commitments: Sequence[Affine],
    z: int,
    values: Sequence[int],
    eta: int,
    proof: IPAProof,
    label: bytes = b"batch",
) -> bool:
    """Homomorphic fold of commitments/values, then single check."""
    r = ck.ctx.curve.fr.modulus
    acc = None
    v = 0
    power = 1
    for c_pt, val in zip(commitments, values):
        acc = ch.add(acc, ch.scalar_mul(c_pt, power))
        v = (v + power * val) % r
        power = power * eta % r
    return check(ck, acc, z, v, proof, label=label)


def _eval_poly(coeffs: Sequence[int], z: int, r: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * z + c) % r
    return acc
