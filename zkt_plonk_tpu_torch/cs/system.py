"""The ConstraintSystem: circuit-builder gate API (dual mode).

Rebuild of ``plonk-core/src/constraint_system/{mod.rs, arithmetic.rs,
boolean.rs}``: every gate runs either against a ``SetupComposer`` (records
selectors/permutation) or a ``ProvingComposer`` (records witness) — the
selector algebra and witness formulas mirror the reference gate-for-gate so
compiled circuits match.
"""

from __future__ import annotations

from typing import List, Optional

from .composer import Selectors, SetupComposer, ProvingComposer
from .lookup import LookupTable
from .variable import LTVariable, ZERO, lt


class Boolean:
    """A variable constrained to {0,1} (``boolean.rs:14-15``)."""

    __slots__ = ("var",)

    def __init__(self, var: int):
        self.var = var


class ConstraintSystem:
    def __init__(self, p: int, setup: bool, lookup_table: LookupTable):
        self.p = p
        self.setup_mode = setup
        self.lookup_table = lookup_table
        self.setup: Optional[SetupComposer] = SetupComposer(p) if setup else None
        self.proving: Optional[ProvingComposer] = ProvingComposer(p) if not setup else None

    # -- bookkeeping -------------------------------------------------------

    @property
    def n(self) -> int:
        return self.setup.n if self.setup_mode else self.proving.n

    def total_size(self) -> int:
        return max(self.n, self.lookup_table.size)

    def circuit_bound(self) -> int:
        n = self.total_size()
        return 1 << max(1, (n - 1).bit_length()) if n > 1 else 1

    def sels(self) -> Selectors:
        return Selectors(self.p)

    def assign_variable(self, value: int) -> int:
        if self.setup_mode:
            return self.setup.perm.new_variable()
        return self.proving.var_map.assign(value % self.p)

    def value_of(self, v) -> int:
        assert not self.setup_mode
        return self.proving.var_map.value_of_lt(lt(v))

    # -- raw gate ----------------------------------------------------------

    def arith_constrain(self, w_l: int, w_r: int, w_o: int, sels: Selectors, pi=None):
        """(a*b)q_m + a*q_l + b*q_r + c*q_o + PI + q_c = 0."""
        if self.setup_mode:
            self.setup.gate_constrain(w_l, w_r, w_o, sels, pi is not None)
        else:
            self.proving.input_wires(w_l, w_r, w_o, pi)

    # -- arithmetic gates (``arithmetic.rs``) ------------------------------

    def add_gate(self, x: LTVariable, y: LTVariable) -> int:
        if self.setup_mode:
            z = self.setup.perm.new_variable()
            sels = self.sels().with_left(1).with_right(1).with_out(-1)
            sels.by_left_lt(x).by_right_lt(y)
            self.setup.gate_constrain(x.var, y.var, z, sels, False)
        else:
            vm = self.proving.var_map
            z = vm.assign(vm.value_of_lt(x) + vm.value_of_lt(y))
            self.proving.input_wires(x.var, y.var, z)
        return z

    def sub_gate(self, x: LTVariable, y: LTVariable) -> int:
        if self.setup_mode:
            z = self.setup.perm.new_variable()
            sels = self.sels().with_left(1).with_right(-1).with_out(-1)
            sels.by_left_lt(x).by_right_lt(y)
            self.setup.gate_constrain(x.var, y.var, z, sels, False)
        else:
            vm = self.proving.var_map
            z = vm.assign(vm.value_of_lt(x) - vm.value_of_lt(y))
            self.proving.input_wires(x.var, y.var, z)
        return z

    def mul_gate(self, x: LTVariable, y: LTVariable) -> int:
        if self.setup_mode:
            z = self.setup.perm.new_variable()
            sels = self.sels().with_mul(1).with_out(-1)
            sels.by_left_lt(x).by_right_lt(y)
            self.setup.gate_constrain(x.var, y.var, z, sels, False)
        else:
            vm = self.proving.var_map
            z = vm.assign(vm.value_of_lt(x) * vm.value_of_lt(y))
            self.proving.input_wires(x.var, y.var, z)
        return z

    def div_gate(self, x: LTVariable, y: LTVariable) -> int:
        """y * z - x = 0  (z = x / y)."""
        if self.setup_mode:
            z = self.setup.perm.new_variable()
            sels = self.sels().with_mul(1).with_out(-1)
            sels.by_left_lt(y).by_out_lt(x)
            self.setup.gate_constrain(y.var, z, x.var, sels, False)
        else:
            vm = self.proving.var_map
            z = vm.assign(vm.value_of_lt(x) * pow(vm.value_of_lt(y), -1, self.p))
            self.proving.input_wires(y.var, z, x.var)
        return z

    def square_gate(self, x: LTVariable) -> int:
        if self.setup_mode:
            y = self.setup.perm.new_variable()
            sels = self.sels().with_mul(1).with_out(-1)
            sels.by_left_lt(x).by_right_lt(x)
            self.setup.gate_constrain(x.var, x.var, y, sels, False)
        else:
            vm = self.proving.var_map
            y = vm.assign(vm.value_of_lt(x) ** 2)
            self.proving.input_wires(x.var, x.var, y)
        return y

    def linear_transform_gate(self, x: LTVariable, y: LTVariable, a: int, b: int, c: int) -> int:
        """a*x + b*y + c = z."""
        if self.setup_mode:
            z = self.setup.perm.new_variable()
            sels = self.sels().with_left(a).with_right(b).with_out(-1).with_constant(c)
            sels.by_left_lt(x).by_right_lt(y)
            self.setup.gate_constrain(x.var, y.var, z, sels, False)
        else:
            vm = self.proving.var_map
            z = vm.assign(vm.value_of_lt(x) * a + vm.value_of_lt(y) * b + c)
            self.proving.input_wires(x.var, y.var, z)
        return z

    # -- boolean gates (``boolean.rs``) ------------------------------------

    def boolean_gate(self, x: int) -> Boolean:
        """x*x - x = 0."""
        sels = self.sels().with_mul(1).with_out(-1)
        self.arith_constrain(x, x, x, sels)
        return Boolean(x)

    def and_gate(self, x: Boolean, y: Boolean) -> Boolean:
        if self.setup_mode:
            z = self.setup.perm.new_variable()
            sels = self.sels().with_mul(1).with_out(-1)
            self.setup.gate_constrain(x.var, y.var, z, sels, False)
        else:
            vm = self.proving.var_map
            z = vm.assign(vm.value_of(x.var) * vm.value_of(y.var))
            self.proving.input_wires(x.var, y.var, z)
        return Boolean(z)

    def or_gate(self, x: Boolean, y: Boolean) -> Boolean:
        """xy - x - y + z = 0."""
        if self.setup_mode:
            z = self.setup.perm.new_variable()
            sels = self.sels().with_mul(1).with_left(-1).with_right(-1).with_out(1)
            self.setup.gate_constrain(x.var, y.var, z, sels, False)
        else:
            vm = self.proving.var_map
            xv, yv = vm.value_of(x.var), vm.value_of(y.var)
            z = vm.assign(xv + yv - xv * yv)
            self.proving.input_wires(x.var, y.var, z)
        return Boolean(z)

    def xor_gate(self, x: Boolean, y: Boolean) -> Boolean:
        """2xy - x - y + z = 0."""
        if self.setup_mode:
            z = self.setup.perm.new_variable()
            sels = self.sels().with_mul(2).with_left(-1).with_right(-1).with_out(1)
            self.setup.gate_constrain(x.var, y.var, z, sels, False)
        else:
            vm = self.proving.var_map
            xv, yv = vm.value_of(x.var), vm.value_of(y.var)
            z = vm.assign(xv + yv - 2 * xv * yv)
            self.proving.input_wires(x.var, y.var, z)
        return Boolean(z)

    def not_and_gate(self, x: Boolean, y: Boolean) -> Boolean:
        """(1-x)y - z = 0."""
        if self.setup_mode:
            z = self.setup.perm.new_variable()
            sels = self.sels().with_mul(-1).with_right(1).with_out(-1)
            self.setup.gate_constrain(x.var, y.var, z, sels, False)
        else:
            vm = self.proving.var_map
            z = vm.assign(vm.value_of(y.var) * (1 - vm.value_of(x.var)))
            self.proving.input_wires(x.var, y.var, z)
        return Boolean(z)

    def nor_gate(self, x: Boolean, y: Boolean) -> Boolean:
        """(1-x)(1-y) - z = 0."""
        if self.setup_mode:
            z = self.setup.perm.new_variable()
            sels = (
                self.sels().with_mul(1).with_left(-1).with_right(-1).with_out(-1).with_constant(1)
            )
            self.setup.gate_constrain(x.var, y.var, z, sels, False)
        else:
            vm = self.proving.var_map
            z = vm.assign((1 - vm.value_of(x.var)) * (1 - vm.value_of(y.var)))
            self.proving.input_wires(x.var, y.var, z)
        return Boolean(z)

    # -- composite gates (``mod.rs:137-453``) ------------------------------

    def lookup_constrain(self, x: LTVariable):
        """Constrain x's (transformed) value to lie in the lookup table."""
        if self.setup_mode:
            w_o = self.setup.perm.new_variable()
            sels = self.sels().with_left(1).with_out(-1)
            sels.q_lookup = 1
            sels.by_left_lt(x)
            self.setup.gate_constrain(x.var, ZERO, w_o, sels, False)
        else:
            vm = self.proving.var_map
            out = vm.value_of_lt(x)
            w_o = vm.assign(out)
            self.proving.input_wires(x.var, ZERO, w_o)

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
                if self.setup_mode:
                    new_var = self.setup.perm.new_variable()
                    sels = self.sels().with_left(1).with_right(multiplier).with_out(-1)
                    self.setup.gate_constrain(a, b, new_var, sels, False)
                else:
                    vm = self.proving.var_map
                    new_var = vm.assign(vm.value_of(a) + vm.value_of(b) * multiplier)
                    self.proving.input_wires(a, b, new_var)
                next_vars.append(new_var)
            vars_ = next_vars
            multiplier = multiplier * multiplier % self.p
        return vars_[0]

    def set_variable_public(self, x: LTVariable):
        if self.setup_mode:
            sels = self.sels().with_out(-1)
            sels.by_out_lt(x)
            self.setup.gate_constrain(ZERO, ZERO, x.var, sels, True)
        else:
            vm = self.proving.var_map
            self.proving.input_wires(ZERO, ZERO, x.var, pi=vm.value_of_lt(x))

    def should_be_zero_with_output(self, x: LTVariable) -> Boolean:
        """Outputs 1 if x == 0 else 0 (``mod.rs:243-282``):
        x*y + z - 1 = 0 ; x*z = 0 with auxiliary y."""
        if self.setup_mode:
            y = self.setup.perm.new_variable()
            z = self.setup.perm.new_variable()
            sels = self.sels().with_mul(1).with_out(1).with_constant(-1)
            sels.by_out_lt(x)
            self.setup.gate_constrain(x.var, y, z, sels, False)
            sels = self.sels().with_mul(1)
            sels.by_out_lt(x)
            self.setup.gate_constrain(x.var, z, ZERO, sels, False)
        else:
            vm = self.proving.var_map
            xv = vm.value_of_lt(x)
            yv = pow(xv, -1, self.p) if xv != 0 else 0
            zv = 1 if xv == 0 else 0
            y = vm.assign(yv)
            z = vm.assign(zv)
            self.proving.input_wires(x.var, y, z)
            self.proving.input_wires(x.var, z, ZERO)
        return Boolean(z)

    def should_eq_with_output(self, x: LTVariable, y: LTVariable) -> Boolean:
        diff = self.sub_gate(x, y)
        return self.should_be_zero_with_output(lt(diff))

    def conditional_select(self, bit: Boolean, choice_a: LTVariable, choice_b: LTVariable) -> int:
        """bit == 1 -> a, bit == 0 -> b (``mod.rs:301-359``)."""
        if self.setup_mode:
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
        else:
            vm = self.proving.var_map
            bv = vm.value_of(bit.var)
            assert bv in (0, 1)
            xv = bv * vm.value_of_lt(choice_a) % self.p
            yv = (1 - bv) * vm.value_of_lt(choice_b) % self.p
            x = vm.assign(xv)
            y = vm.assign(yv)
            z = vm.assign(xv + yv)
            self.proving.input_wires(bit.var, choice_a.var, x)
            self.proving.input_wires(bit.var, choice_b.var, y)
            self.proving.input_wires(x, y, z)
        return z

    def conditional_select_zero(self, bit: Boolean, value: LTVariable) -> int:
        """bit == 1 -> value, bit == 0 -> 0."""
        if self.setup_mode:
            out = self.setup.perm.new_variable()
            sels = self.sels().with_mul(1).with_out(-1)
            sels.by_right_lt(value)
            self.setup.gate_constrain(bit.var, value.var, out, sels, False)
        else:
            vm = self.proving.var_map
            bv = vm.value_of(bit.var)
            assert bv in (0, 1)
            out = vm.assign(0 if bv == 0 else vm.value_of_lt(value))
            self.proving.input_wires(bit.var, value.var, out)
        return out

    def conditional_select_one(self, bit: Boolean, value: LTVariable) -> int:
        """bit == 1 -> value, bit == 0 -> 1: bit*value - bit - out + 1 = 0."""
        if self.setup_mode:
            out = self.setup.perm.new_variable()
            sels = self.sels().with_mul(1).with_left(-1).with_out(-1).with_constant(1)
            sels.by_right_lt(value)
            self.setup.gate_constrain(bit.var, value.var, out, sels, False)
        else:
            vm = self.proving.var_map
            bv = vm.value_of(bit.var)
            assert bv in (0, 1)
            out = vm.assign(1 if bv == 0 else vm.value_of_lt(value))
            self.proving.input_wires(bit.var, value.var, out)
        return out
