"""Variables and linear-transformed variables.

Rebuild of ``plonk-core/src/constraint_system/variable.rs:16-154``:
``Variable`` is either the always-zero wire or an index into the witness
value table; ``LTVariable`` carries a (coeff, offset) affine transform that
gate builders fold into selectors at zero gate cost.

Values are canonical Python ints mod the field modulus.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

ZERO = -1  # the always-zero variable (reference: Variable::Zero)


@dataclass(frozen=True)
class LTVariable:
    """var with affine transform: value = coeff * value_of(var) + offset."""

    var: int  # ZERO or index
    coeff: int
    offset: int

    @staticmethod
    def of(var: int, p: int) -> "LTVariable":
        return LTVariable(var, 1, 0)

    @staticmethod
    def zero() -> "LTVariable":
        return LTVariable(ZERO, 1, 0)

    @staticmethod
    def constant(value: int) -> "LTVariable":
        return LTVariable(ZERO, 1, value)

    def linear_transform(self, coeff: int, offset: int, p: int) -> "LTVariable":
        # NOTE: replicates the reference's composition exactly
        # (variable.rs:77-86): the new offset uses the *composed* coeff.
        new_coeff = self.coeff * coeff % p
        new_offset = (self.offset * new_coeff + offset) % p
        return LTVariable(self.var, new_coeff, new_offset)


def lt(var) -> LTVariable:
    """Variable -> LTVariable (identity transform)."""
    if isinstance(var, LTVariable):
        return var
    return LTVariable(int(var), 1, 0)


class VariableMap:
    """Witness values (proving mode). ``variable.rs:92-146``."""

    __slots__ = ("values", "p")

    def __init__(self, p: int):
        self.values: List[int] = []
        self.p = p

    def assign(self, value: int) -> int:
        self.values.append(value % self.p)
        return len(self.values) - 1

    def value_of(self, var: int) -> int:
        return 0 if var == ZERO else self.values[var]

    def value_of_lt(self, v: LTVariable) -> int:
        return (self.value_of(v.var) * v.coeff + v.offset) % self.p

    def __len__(self):
        return len(self.values)
