"""Curve context: bundles host field classes, generators and tower data."""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

from ..fields.host import make_field
from ..fields.limbs import make_spec
from ..fields.params import CurveParams, get_curve
from .tower import Fq2, TowerCtx


@dataclass(frozen=True, eq=False)
class CurveCtx:
    curve: CurveParams
    Fq: type
    Fr: type
    tower: TowerCtx

    @property
    def name(self) -> str:
        return self.curve.name

    @property
    def fq_spec(self):
        return make_spec(self.curve.fq)

    @property
    def fr_spec(self):
        return make_spec(self.curve.fr)

    @property
    def b(self):
        return self.Fq(self.curve.b)

    @property
    def b2(self) -> Fq2:
        return Fq2(self.tower, *self.curve.b2)

    @property
    def g1(self) -> Tuple:
        x, y = self.curve.g1
        return (self.Fq(x), self.Fq(y))

    @property
    def g2(self) -> Tuple[Fq2, Fq2]:
        (x0, x1), (y0, y1) = self.curve.g2
        return (Fq2(self.tower, x0, x1), Fq2(self.tower, y0, y1))


@lru_cache(maxsize=None)
def make_context(name: str) -> CurveCtx:
    curve = get_curve(name)
    return CurveCtx(
        curve=curve,
        Fq=make_field(curve.fq),
        Fr=make_field(curve.fr),
        tower=TowerCtx.for_curve(curve),
    )
