"""The ConstraintSystem: circuit-builder gate API (setup mode).

Rebuild of ``plonk-core/src/constraint_system/{mod.rs, arithmetic.rs,
boolean.rs}`` in setup mode: every gate records its selectors and its
wires' permutation into a ``SetupComposer``; the selector algebra mirrors
the reference gate for gate, so compiled circuits match.
"""

from __future__ import annotations

from typing import List

from .composer import Selectors, SetupComposer
from .variable import LTVariable, ZERO, lt


class Boolean:
    """A variable constrained to {0,1} (``boolean.rs:14-15``)."""

    __slots__ = ("var",)

    def __init__(self, var: int):
        self.var = var


class ConstraintSystem:
    """Setup mode only: every gate records its selectors and wires into a
    ``SetupComposer``; witness values are not kept."""

    def __init__(self, p: int, table_size: int):
        self.p = p
        self.table_size = table_size
        self.setup = SetupComposer(p)

    # -- bookkeeping -------------------------------------------------------

    @property
    def n(self) -> int:
        return self.setup.n

    def total_size(self) -> int:
        return max(self.n, self.table_size)

    def circuit_bound(self) -> int:
        n = self.total_size()
        return 1 << max(1, (n - 1).bit_length()) if n > 1 else 1

    def sels(self) -> Selectors:
        return Selectors(self.p)

    def assign_variable(self, value: int) -> int:
        return self.setup.perm.new_variable()

    # -- raw gate ----------------------------------------------------------

    def arith_constrain(self, w_l: int, w_r: int, w_o: int, sels: Selectors, pi=None):
        """(a*b)q_m + a*q_l + b*q_r + c*q_o + PI + q_c = 0."""
        self.setup.gate_constrain(w_l, w_r, w_o, sels, pi is not None)

    # -- arithmetic gates (``arithmetic.rs``) ------------------------------

    def add_gate(self, x: LTVariable, y: LTVariable) -> int:
        z = self.setup.perm.new_variable()
        sels = self.sels().with_left(1).with_right(1).with_out(-1)
        sels.by_left_lt(x).by_right_lt(y)
        self.setup.gate_constrain(x.var, y.var, z, sels, False)
        return z

    def sub_gate(self, x: LTVariable, y: LTVariable) -> int:
        z = self.setup.perm.new_variable()
        sels = self.sels().with_left(1).with_right(-1).with_out(-1)
        sels.by_left_lt(x).by_right_lt(y)
        self.setup.gate_constrain(x.var, y.var, z, sels, False)
        return z

    def mul_gate(self, x: LTVariable, y: LTVariable) -> int:
        z = self.setup.perm.new_variable()
        sels = self.sels().with_mul(1).with_out(-1)
        sels.by_left_lt(x).by_right_lt(y)
        self.setup.gate_constrain(x.var, y.var, z, sels, False)
        return z

    def div_gate(self, x: LTVariable, y: LTVariable) -> int:
        """y * z - x = 0  (z = x / y)."""
        z = self.setup.perm.new_variable()
        sels = self.sels().with_mul(1).with_out(-1)
        sels.by_left_lt(y).by_out_lt(x)
        self.setup.gate_constrain(y.var, z, x.var, sels, False)
        return z

    def square_gate(self, x: LTVariable) -> int:
        y = self.setup.perm.new_variable()
        sels = self.sels().with_mul(1).with_out(-1)
        sels.by_left_lt(x).by_right_lt(x)
        self.setup.gate_constrain(x.var, x.var, y, sels, False)
        return y

    def linear_transform_gate(self, x: LTVariable, y: LTVariable, a: int, b: int, c: int) -> int:
        """a*x + b*y + c = z."""
        z = self.setup.perm.new_variable()
        sels = self.sels().with_left(a).with_right(b).with_out(-1).with_constant(c)
        sels.by_left_lt(x).by_right_lt(y)
        self.setup.gate_constrain(x.var, y.var, z, sels, False)
        return z

    # -- boolean gates (``boolean.rs``) ------------------------------------

    def boolean_gate(self, x: int) -> Boolean:
        """x*x - x = 0."""
        sels = self.sels().with_mul(1).with_out(-1)
        self.arith_constrain(x, x, x, sels)
        return Boolean(x)

    def and_gate(self, x: Boolean, y: Boolean) -> Boolean:
        z = self.setup.perm.new_variable()
        sels = self.sels().with_mul(1).with_out(-1)
        self.setup.gate_constrain(x.var, y.var, z, sels, False)
        return Boolean(z)

    def or_gate(self, x: Boolean, y: Boolean) -> Boolean:
        """xy - x - y + z = 0."""
        z = self.setup.perm.new_variable()
        sels = self.sels().with_mul(1).with_left(-1).with_right(-1).with_out(1)
        self.setup.gate_constrain(x.var, y.var, z, sels, False)
        return Boolean(z)

    def xor_gate(self, x: Boolean, y: Boolean) -> Boolean:
        """2xy - x - y + z = 0."""
        z = self.setup.perm.new_variable()
        sels = self.sels().with_mul(2).with_left(-1).with_right(-1).with_out(1)
        self.setup.gate_constrain(x.var, y.var, z, sels, False)
        return Boolean(z)

    def not_and_gate(self, x: Boolean, y: Boolean) -> Boolean:
        """(1-x)y - z = 0."""
        z = self.setup.perm.new_variable()
        sels = self.sels().with_mul(-1).with_right(1).with_out(-1)
        self.setup.gate_constrain(x.var, y.var, z, sels, False)
        return Boolean(z)

    def nor_gate(self, x: Boolean, y: Boolean) -> Boolean:
        """(1-x)(1-y) - z = 0."""
        z = self.setup.perm.new_variable()
        sels = (
            self.sels().with_mul(1).with_left(-1).with_right(-1).with_out(-1).with_constant(1)
        )
        self.setup.gate_constrain(x.var, y.var, z, sels, False)
        return Boolean(z)

    # -- composite gates (``mod.rs:137-453``) ------------------------------

    def lookup_constrain(self, x: LTVariable):
        """Constrain x's (transformed) value to lie in the lookup table."""
        w_o = self.setup.perm.new_variable()
        sels = self.sels().with_left(1).with_out(-1)
        sels.q_lookup = 1
        sels.by_left_lt(x)
        self.setup.gate_constrain(x.var, ZERO, w_o, sels, False)

    def equal_constrain(self, x: LTVariable, y: LTVariable):
        sels = self.sels().with_left(1).with_right(-1)
        sels.by_left_lt(x).by_right_lt(y)
        self.arith_constrain(x.var, y.var, ZERO, sels)

    def bits_le_constrain(self, bits: List[Boolean]) -> int:
        """Recombine boolean bits (little-endian) into a variable
        (``mod.rs:172-212``); length must be a power of two."""
        assert len(bits) & (len(bits) - 1) == 0, "bits length must be a power of two"
        vars_ = [b.var for b in bits]
        multiplier = 2
        while len(vars_) > 1:
            next_vars = []
            for i in range(0, len(vars_), 2):
                a, b = vars_[i], vars_[i + 1]
                new_var = self.setup.perm.new_variable()
                sels = self.sels().with_left(1).with_right(multiplier).with_out(-1)
                self.setup.gate_constrain(a, b, new_var, sels, False)
                next_vars.append(new_var)
            vars_ = next_vars
            multiplier = multiplier * multiplier % self.p
        return vars_[0]

    def set_variable_public(self, x: LTVariable):
        sels = self.sels().with_out(-1)
        sels.by_out_lt(x)
        self.setup.gate_constrain(ZERO, ZERO, x.var, sels, True)

    def should_be_zero_with_output(self, x: LTVariable) -> Boolean:
        """Outputs 1 if x == 0 else 0 (``mod.rs:243-282``):
        x*y + z - 1 = 0 ; x*z = 0 with auxiliary y."""
        y = self.setup.perm.new_variable()
        z = self.setup.perm.new_variable()
        sels = self.sels().with_mul(1).with_out(1).with_constant(-1)
        sels.by_out_lt(x)
        self.setup.gate_constrain(x.var, y, z, sels, False)
        sels = self.sels().with_mul(1)
        sels.by_out_lt(x)
        self.setup.gate_constrain(x.var, z, ZERO, sels, False)
        return Boolean(z)

    def should_eq_with_output(self, x: LTVariable, y: LTVariable) -> Boolean:
        diff = self.sub_gate(x, y)
        return self.should_be_zero_with_output(lt(diff))

    def conditional_select(self, bit: Boolean, choice_a: LTVariable, choice_b: LTVariable) -> int:
        """bit == 1 -> a, bit == 0 -> b (``mod.rs:301-359``)."""
        x = self.setup.perm.new_variable()
        y = self.setup.perm.new_variable()
        z = self.setup.perm.new_variable()
        sels = self.sels().with_mul(1).with_out(-1)
        sels.by_right_lt(choice_a)
        self.setup.gate_constrain(bit.var, choice_a.var, x, sels, False)
        sels = self.sels().with_mul(-1).with_right(1).with_out(-1)
        sels.by_right_lt(choice_b)
        self.setup.gate_constrain(bit.var, choice_b.var, y, sels, False)
        sels = self.sels().with_left(1).with_right(1).with_out(-1)
        self.setup.gate_constrain(x, y, z, sels, False)
        return z

    def conditional_select_zero(self, bit: Boolean, value: LTVariable) -> int:
        """bit == 1 -> value, bit == 0 -> 0."""
        out = self.setup.perm.new_variable()
        sels = self.sels().with_mul(1).with_out(-1)
        sels.by_right_lt(value)
        self.setup.gate_constrain(bit.var, value.var, out, sels, False)
        return out

    def conditional_select_one(self, bit: Boolean, value: LTVariable) -> int:
        """bit == 1 -> value, bit == 0 -> 1: bit*value - bit - out + 1 = 0."""
        out = self.setup.perm.new_variable()
        sels = self.sels().with_mul(1).with_left(-1).with_out(-1).with_constant(1)
        sels.by_right_lt(value)
        self.setup.gate_constrain(bit.var, value.var, out, sels, False)
        return out
