"""Host-side elliptic-curve point arithmetic (affine, generic over field).

Used for: G1/G2 generators, SRS G2 elements, the verifier's small MSMs
(13 points — ``proof.rs:220-282`` in the reference), and subgroup/on-curve
checks.  Bulk MSMs run on device (``ops/msm.py``).

Points are ``None`` (infinity) or ``(x, y)`` tuples of field elements that
support +, -, *, unary -, ``inverse()`` and ``is_zero()`` — this covers both
``FpElement`` (G1) and ``Fq2`` (G2).
"""

from __future__ import annotations

from typing import Optional, Tuple

Point = Optional[Tuple[object, object]]


def is_on_curve(pt: Point, b) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - (x * x * x + b)).is_zero()


def neg(pt: Point) -> Point:
    if pt is None:
        return None
    return (pt[0], -pt[1])


def add(p1: Point, p2: Point) -> Point:
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2).is_zero():
            return None
        # doubling
        lam = (x1 * x1 * 3) * (y1 * 2).inverse()
    else:
        lam = (y2 - y1) * (x2 - x1).inverse()
    x3 = lam * lam - x1 - x2
    y3 = lam * (x1 - x3) - y1
    return (x3, y3)


def double(pt: Point) -> Point:
    return add(pt, pt)


def scalar_mul(pt: Point, k: int) -> Point:
    if k == 0 or pt is None:
        return None
    if k < 0:
        return scalar_mul(neg(pt), -k)
    acc = None
    base = pt
    while k:
        if k & 1:
            acc = add(acc, base)
        base = add(base, base)
        k >>= 1
    return acc


def msm(points, scalars) -> Point:
    """Small host MSM (naive double-and-add sum); fine for O(10) points."""
    acc = None
    for pt, s in zip(points, scalars):
        acc = add(acc, scalar_mul(pt, int(s)))
    return acc
