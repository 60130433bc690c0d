"""Extension-field towers (host side): Fq2, Fq6, Fq12.

Needed for G2 arithmetic (SRS [tau]_2) and pairings in KZG verification —
the host-side equivalent of arkworks' pairing machinery that the reference
delegates to (``plonk-core/src/commitment.rs:24-46``).  Verification is
O(small), so Python ints are the right tool; the prover never touches this.

Tower (BN254 and BLS12-381 share the shape):
  Fq2  = Fq [u] / (u^2 + 1)
  Fq6  = Fq2[v] / (v^3 - xi)        xi = 9 + u (BN254), 1 + u (BLS12-381)
  Fq12 = Fq6[w] / (w^2 - v)
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

from ..fields.params import CurveParams


@dataclass(frozen=True)
class TowerCtx:
    p: int
    # xi = xi0 + xi1*u, the Fq6 cubic non-residue
    xi: Tuple[int, int]
    # u^2 = -beta (beta = curve.fq2_nonresidue): 1 for bn254/bls12-381, 5
    # for bls12-377.  -beta must be a quadratic non-residue mod p so that
    # Fq2 is a field and x^p = conjugate(x).
    beta: int = 1

    @staticmethod
    def for_curve(curve: CurveParams) -> "TowerCtx":
        if curve.name == "bn254":
            return TowerCtx(p=curve.fq.modulus, xi=(9, 1))
        if curve.name == "bls12_381":
            return TowerCtx(p=curve.fq.modulus, xi=(1, 1))
        if curve.name == "bls12_377":
            # Fq6 = Fq2[v]/(v^3 - u): xi = u (arkworks bls12_377 tower)
            return TowerCtx(p=curve.fq.modulus, xi=(0, 1), beta=curve.fq2_nonresidue)
        raise ValueError(curve.name)


class Fq2:
    """a + b*u with u^2 = -beta. Immutable."""

    __slots__ = ("ctx", "a", "b")

    def __init__(self, ctx: TowerCtx, a: int, b: int):
        object.__setattr__(self, "ctx", ctx)
        object.__setattr__(self, "a", a % ctx.p)
        object.__setattr__(self, "b", b % ctx.p)

    def __setattr__(self, *_):
        raise AttributeError("immutable")

    # helpers
    def _new(self, a, b):
        return Fq2(self.ctx, a, b)

    @staticmethod
    def zero(ctx):
        return Fq2(ctx, 0, 0)

    @staticmethod
    def one(ctx):
        return Fq2(ctx, 1, 0)

    def __add__(self, o):
        return self._new(self.a + o.a, self.b + o.b)

    def __sub__(self, o):
        return self._new(self.a - o.a, self.b - o.b)

    def __neg__(self):
        return self._new(-self.a, -self.b)

    def __mul__(self, o):
        if isinstance(o, int):
            return self._new(self.a * o, self.b * o)
        p = self.ctx.p
        t0 = self.a * o.a % p
        t1 = self.b * o.b % p
        t2 = (self.a + self.b) * (o.a + o.b) % p
        return self._new(t0 - self.ctx.beta * t1, t2 - t0 - t1)

    __rmul__ = __mul__

    def square(self):
        p = self.ctx.p
        t0 = (self.a * self.a - self.ctx.beta * self.b * self.b) % p
        t1 = 2 * self.a * self.b % p
        return self._new(t0, t1)

    def conjugate(self):
        return self._new(self.a, -self.b)

    def inverse(self):
        p = self.ctx.p
        norm = (self.a * self.a + self.ctx.beta * self.b * self.b) % p
        ninv = pow(norm, -1, p)
        return self._new(self.a * ninv, -self.b * ninv)

    def __truediv__(self, o):
        return self * o.inverse()

    def pow(self, e: int):
        r, base = Fq2.one(self.ctx), self
        while e:
            if e & 1:
                r = r * base
            base = base.square()
            e >>= 1
        return r

    def frobenius(self):
        return self.conjugate()  # x^p for u^2 = -1

    def is_zero(self):
        return self.a == 0 and self.b == 0

    def __eq__(self, o):
        return isinstance(o, Fq2) and self.a == o.a and self.b == o.b

    def __hash__(self):
        return hash((self.a, self.b))

    def __repr__(self):
        return f"Fq2({self.a}, {self.b})"

    def mul_by_nonresidue(self):
        """Multiply by xi (the Fq6 non-residue)."""
        xi0, xi1 = self.ctx.xi
        return self * Fq2(self.ctx, xi0, xi1)


class Fq6:
    """c0 + c1*v + c2*v^2 with v^3 = xi."""

    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fq2, c1: Fq2, c2: Fq2):
        object.__setattr__(self, "c0", c0)
        object.__setattr__(self, "c1", c1)
        object.__setattr__(self, "c2", c2)

    def __setattr__(self, *_):
        raise AttributeError("immutable")

    @staticmethod
    def zero(ctx):
        z = Fq2.zero(ctx)
        return Fq6(z, z, z)

    @staticmethod
    def one(ctx):
        return Fq6(Fq2.one(ctx), Fq2.zero(ctx), Fq2.zero(ctx))

    def __add__(self, o):
        return Fq6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o):
        return Fq6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self):
        return Fq6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o):
        if isinstance(o, Fq2):
            return Fq6(self.c0 * o, self.c1 * o, self.c2 * o)
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0, t1, t2 = a0 * b0, a1 * b1, a2 * b2
        c0 = ((a1 + a2) * (b1 + b2) - t1 - t2).mul_by_nonresidue() + t0
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2.mul_by_nonresidue()
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fq6(c0, c1, c2)

    def square(self):
        return self * self

    def mul_by_v(self):
        """Multiply by v."""
        return Fq6(self.c2.mul_by_nonresidue(), self.c0, self.c1)

    def inverse(self):
        a0, a1, a2 = self.c0, self.c1, self.c2
        t0 = a0.square() - (a1 * a2).mul_by_nonresidue()
        t1 = (a2.square()).mul_by_nonresidue() - a0 * a1
        t2 = a1.square() - a0 * a2
        det = a0 * t0 + (a2 * t1 + a1 * t2).mul_by_nonresidue()
        dinv = det.inverse()
        return Fq6(t0 * dinv, t1 * dinv, t2 * dinv)

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1 and self.c2 == o.c2

    def __hash__(self):
        return hash((self.c0, self.c1, self.c2))


class Fq12:
    """c0 + c1*w with w^2 = v."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq6, c1: Fq6):
        object.__setattr__(self, "c0", c0)
        object.__setattr__(self, "c1", c1)

    def __setattr__(self, *_):
        raise AttributeError("immutable")

    @staticmethod
    def one(ctx):
        return Fq12(Fq6.one(ctx), Fq6.zero(ctx))

    def __add__(self, o):
        return Fq12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fq12(self.c0 - o.c0, self.c1 - o.c1)

    def __mul__(self, o):
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        t0 = a0 * b0
        t1 = a1 * b1
        c0 = t0 + t1.mul_by_v()
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1
        return Fq12(c0, c1)

    def square(self):
        return self * self

    def conjugate(self):
        return Fq12(self.c0, -self.c1)

    def inverse(self):
        t = (self.c0.square() - self.c1.square().mul_by_v()).inverse()
        return Fq12(self.c0 * t, -(self.c1 * t))

    def pow(self, e: int):
        ctx = self.c0.c0.ctx
        r, base = Fq12.one(ctx), self
        while e:
            if e & 1:
                r = r * base
            base = base.square()
            e >>= 1
        return r

    def is_one(self):
        ctx = self.c0.c0.ctx
        return self == Fq12.one(ctx)

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash((self.c0, self.c1))


@lru_cache(maxsize=None)
def tower_ctx(curve_name: str) -> TowerCtx:
    from ..fields.params import get_curve

    return TowerCtx.for_curve(get_curve(curve_name))
