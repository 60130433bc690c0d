"""Variables and linear-transformed variables.

Rebuild of ``plonk-core/src/constraint_system/variable.rs:16-154``:
``Variable`` is either the always-zero wire or an index into the witness
value table; ``LTVariable`` carries a (coeff, offset) affine transform that
gate builders fold into selectors at zero gate cost.

Values are canonical Python ints mod the field modulus.
"""

from __future__ import annotations

from dataclasses import dataclass

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
