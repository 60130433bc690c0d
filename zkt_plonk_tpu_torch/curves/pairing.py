"""Optimal ate pairings (host side, verification only).

Replaces the arkworks ``PairingEngine`` the reference's KZG check relies on
(``ark-poly-commit`` SonicKZG10, via ``plonk-core/src/commitment.rs:24-46``).
Verification cost is O(1) pairings, so a clear Python-int implementation is
the right tool; the prover never computes pairings.

Conventions (see ``curves/tower.py``): Fq12 = Fq6[w]/(w^2 - v), v^3 = xi.
Twist handling follows ``CurveParams.twist_type``:

* D-type (BN254, b2 = b/xi): untwist psi(x, y) = (x*w^2, y*w^3) maps the
  twist into E(Fq12); the line evaluated at P in G1 is sparse as
  yp + (-lam*xp)*w + (lam*x_t - y_t)*w^3.
* M-type (BLS12-381, b2 = b*xi): instead P is mapped ONTO the twist via
  (xp*w^2, yp*w^3); the twist-curve line evaluated there is sparse as
  (lam*x_t - y_t) + (-lam*xp)*w^2 + yp*w^3.

BN254:  ate loop 6t+2 (t = 4965661367192848881) + two frobenius line steps.
BLS12-381: ate loop |z| with a final conjugation (z < 0).
"""

from __future__ import annotations

from typing import List, Tuple

from .context import CurveCtx, make_context
from .tower import Fq2, Fq6, Fq12


def _embed_fq(ctx: CurveCtx, v) -> Fq2:
    return Fq2(ctx.tower, int(v), 0)


def _line_eval(ctx: CurveCtx, t, q, p) -> Tuple[Fq12, Tuple[Fq2, Fq2]]:
    """Line through twist points t, q (affine Fq2 coords), evaluated at
    p = (xp, yp) in G1.  Returns (line value in Fq12, t + q on the twist).

    D-type: l(P) = yp - lam*xp*w + (lam*x_t - y_t)*w^3.
    M-type: l(P) = (lam*x_t - y_t) - lam*xp*w^2 + yp*w^3.
    (w^2 = v, w^3 = v*w in the Fq12 = Fq6[w], Fq6 = Fq2[v] tower.)
    """
    x1, y1 = t
    x2, y2 = q
    if x1 == x2 and y1 == y2:
        lam = (x1.square() * 3) * (y1 * 2).inverse()
    else:
        assert not (x1 == x2), "degenerate line in Miller loop"
        lam = (y2 - y1) * (x2 - x1).inverse()
    x3 = lam.square() - x1 - x2
    y3 = lam * (x1 - x3) - y1

    yp = _embed_fq(ctx, p[1])
    mlxp = -(lam * int(p[0]))
    ct = lam * x1 - y1
    z = Fq2.zero(ctx.tower)
    if ctx.curve.twist_type == "D":
        line = Fq12(Fq6(yp, z, z), Fq6(mlxp, ct, z))
    else:  # M-type
        line = Fq12(Fq6(ct, mlxp, z), Fq6(z, yp, z))
    return line, (x3, y3)


def _g2_frobenius(ctx: CurveCtx, q: Tuple[Fq2, Fq2]) -> Tuple[Fq2, Fq2]:
    """Twist-coordinate Frobenius: psi^{-1} ∘ pi_p ∘ psi."""
    p = ctx.tower.p
    xi = Fq2(ctx.tower, *ctx.tower.xi)
    w2 = xi.pow((p - 1) // 3)
    w3 = xi.pow((p - 1) // 2)
    x, y = q
    return (x.conjugate() * w2, y.conjugate() * w3)


def miller_loop(ctx: CurveCtx, p, q) -> Fq12:
    """Single Miller loop f_{loop}(P, Q); inputs are affine host points."""
    curve = ctx.curve
    loop = curve.ate_loop_count
    assert loop is not None, f"no pairing data for {curve.name}"

    f = Fq12.one(ctx.tower)
    t = q
    for i in range(loop.bit_length() - 2, -1, -1):
        f = f.square()
        line, t = _line_eval(ctx, t, t, p)
        f = f * line
        if (loop >> i) & 1:
            line, t = _line_eval(ctx, t, q, p)
            f = f * line

    if curve.curve_family == "bn":
        # two extra steps with pi(Q) and -pi^2(Q)
        q1 = _g2_frobenius(ctx, q)
        q2 = _g2_frobenius(ctx, q1)
        q2_neg = (q2[0], -q2[1])
        line, t = _line_eval(ctx, t, q1, p)
        f = f * line
        line, t = _line_eval(ctx, t, q2_neg, p)
        f = f * line
    elif curve.ate_is_negative:
        f = f.conjugate()

    return f


def final_exponentiation(ctx: CurveCtx, f: Fq12) -> Fq12:
    p = ctx.tower.p
    r = ctx.curve.fr.modulus
    return f.pow((p**12 - 1) // r)


def multi_pairing(ctx: CurveCtx, pairs: List[Tuple]) -> Fq12:
    """prod_i e(P_i, Q_i) — shared final exponentiation."""
    f = Fq12.one(ctx.tower)
    for p, q in pairs:
        if p is None or q is None:
            continue
        f = f * miller_loop(ctx, p, q)
    return final_exponentiation(ctx, f)


def pairing(ctx: CurveCtx, p, q) -> Fq12:
    return final_exponentiation(ctx, miller_loop(ctx, p, q))


def pairing_product_is_one(ctx: CurveCtx, pairs: List[Tuple]) -> bool:
    return multi_pairing(ctx, pairs).is_one()
