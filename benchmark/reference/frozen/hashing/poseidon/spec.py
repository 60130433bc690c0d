"""Poseidon hasher — dual backend: native ints or circuit gates.

Rebuild of ``plonk-hashing/src/hasher/poseidon/spec.rs``: the same round
schedule runs either on plain field ints (``NativePlonkSpecRef``) or on the
ConstraintSystem emitting gates on ``LTVariable``s (``PlonkSpecRef``, where
constant add/mul fold into the affine transform at zero gate cost).

Gate counts match the reference emission exactly (every ``add`` is an
add_gate, every ``mul`` a mul_gate; constants are free).
"""

from __future__ import annotations

from typing import List, Union

from ...cs.system import ConstraintSystem
from ...cs.variable import LTVariable
from .constants import PoseidonConstants


class FullBufferError(Exception):
    pass


class _NativeOps:
    """Plain modular-int backend (``spec.rs:139-170``)."""

    def __init__(self, p: int):
        self.p = p

    def constant(self, v):
        return v % self.p

    def zero(self):
        return 0

    def add(self, cs, x, y):
        return (x + y) % self.p

    def add_constant(self, cs, x, c):
        return (x + c) % self.p

    def mul(self, cs, x, y):
        return x * y % self.p

    def mul_constant(self, cs, x, c):
        return x * c % self.p


class _CircuitOps:
    """Gate-emitting backend on LTVariables (``spec.rs:172-219``)."""

    def __init__(self, p: int):
        self.p = p

    def constant(self, v):
        return LTVariable.constant(v % self.p)

    def zero(self):
        return LTVariable.zero()

    def add(self, cs: ConstraintSystem, x: LTVariable, y: LTVariable):
        return LTVariable(cs.add_gate(x, y), 1, 0)

    def add_constant(self, cs, x: LTVariable, c):
        return x.linear_transform(1, c % self.p, self.p)

    def mul(self, cs: ConstraintSystem, x: LTVariable, y: LTVariable):
        return LTVariable(cs.mul_gate(x, y), 1, 0)

    def mul_constant(self, cs, x: LTVariable, c):
        return x.linear_transform(c % self.p, 0, self.p)


class Poseidon:
    """Fixed-arity Poseidon hasher (``spec.rs:223-360``).

    ``native=True`` computes on ints; otherwise inputs/outputs are
    LTVariables and gates are emitted into the provided cs.
    """

    def __init__(self, constants: PoseidonConstants, native: bool):
        self.constants = constants
        self.ops = _NativeOps(constants.p) if native else _CircuitOps(constants.p)
        self.native = native
        self._reset()

    # -- sponge-ish state --------------------------------------------------

    def _reset(self):
        c = self.constants
        self.elements = [self.ops.zero() for _ in range(c.width)]
        self.elements[0] = self.ops.constant(c.domain_tag)
        self.pos = 1
        self.constants_offset = 0

    def input(self, value) -> int:
        if self.pos >= self.constants.width:
            raise FullBufferError("cannot input more elements than arity")
        self.elements[self.pos] = value
        self.pos += 1
        return self.pos - 1

    # -- rounds ------------------------------------------------------------

    def _quintic_s_box(self, cs, x, pre_add=None):
        ops = self.ops
        tmp = ops.add_constant(cs, x, pre_add) if pre_add is not None else x
        sq = ops.mul(cs, tmp, tmp)
        quad = ops.mul(cs, sq, sq)
        return ops.mul(cs, quad, tmp)

    def _product_mds(self, cs):
        c, ops = self.constants, self.ops
        w = c.width
        result = [ops.zero() for _ in range(w)]
        for j in range(w):
            for i in range(w):
                tmp = ops.mul_constant(cs, self.elements[i], c.mds[i][j])
                result[j] = ops.add(cs, result[j], tmp)
        self.elements = result

    def _full_round(self, cs):
        c = self.constants
        off = self.constants_offset
        self.elements = [
            self._quintic_s_box(cs, el, pre_add=c.round_constants[off + i])
            for i, el in enumerate(self.elements)
        ]
        self.constants_offset += c.width
        self._product_mds(cs)

    def _partial_round(self, cs):
        c, ops = self.constants, self.ops
        off = self.constants_offset
        self.elements = [
            ops.add_constant(cs, el, c.round_constants[off + i])
            for i, el in enumerate(self.elements)
        ]
        self.constants_offset += c.width
        self.elements[0] = self._quintic_s_box(cs, self.elements[0])
        self._product_mds(cs)

    def output_hash(self, cs=None):
        c = self.constants
        for _ in range(c.half_full_rounds):
            self._full_round(cs)
        for _ in range(c.partial_rounds):
            self._partial_round(cs)
        for _ in range(c.half_full_rounds):
            self._full_round(cs)
        return self.elements[1]

    # -- FieldHasher interface (``hasher/mod.rs:8-34``) --------------------

    def hash(self, cs, inputs: List) -> Union[int, LTVariable]:
        self._reset()
        for el in inputs:
            self.input(el)
        return self.output_hash(cs)

    def hash_two(self, cs, left, right):
        return self.hash(cs, [left, right])

    @staticmethod
    def empty_hash():
        return 0
