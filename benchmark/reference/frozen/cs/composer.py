"""Selectors, the setup composer and the copy-constraint permutation.

Rebuild of ``plonk-core/src/constraint_system/composer.rs`` and
``plonk-core/src/permutation/mod.rs`` in setup mode: synthesis records the
selector columns, the public inputs' positions and the wire permutation,
from which the verifier key's columns are derived.  No witness is kept.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from .variable import LTVariable, ZERO

# coset generators for the permutation argument (``permutation/constants.rs``)
K1 = 7
K2 = 13

_L, _R, _O = 0, 1, 2  # wire kinds


@dataclass
class Selectors:
    """One gate row of selector values (ints mod p).

    The ``by_*_lt`` folds replicate ``composer.rs:85-115``: an affine
    transform (coeff, offset) on a wire is absorbed into the selectors so
    ``LTVariable``s cost zero extra gates.
    """

    p: int
    q_m: int = 0
    q_l: int = 0
    q_r: int = 0
    q_o: int = 0
    q_c: int = 0
    q_lookup: int = 0

    def with_mul(self, v):
        self.q_m = v % self.p
        return self

    def with_left(self, v):
        self.q_l = v % self.p
        return self

    def with_right(self, v):
        self.q_r = v % self.p
        return self

    def with_out(self, v):
        self.q_o = v % self.p
        return self

    def with_constant(self, v):
        self.q_c = v % self.p
        return self

    def with_lookup(self):
        self.q_lookup = 1
        return self

    def by_left_lt(self, w_l: LTVariable):
        p = self.p
        q_m = self.q_m * w_l.coeff % p
        q_l = self.q_l * w_l.coeff % p
        self.q_r = (self.q_r + self.q_m * w_l.offset) % p
        self.q_c = (self.q_c + self.q_l * w_l.offset) % p
        self.q_m, self.q_l = q_m, q_l
        return self

    def by_right_lt(self, w_r: LTVariable):
        p = self.p
        q_m = self.q_m * w_r.coeff % p
        q_r = self.q_r * w_r.coeff % p
        self.q_l = (self.q_l + self.q_m * w_r.offset) % p
        self.q_c = (self.q_c + self.q_r * w_r.offset) % p
        self.q_m, self.q_r = q_m, q_r
        return self

    def by_out_lt(self, w_o: LTVariable):
        p = self.p
        q_o = self.q_o * w_o.coeff % p
        self.q_c = (self.q_c + self.q_o * w_o.offset) % p
        self.q_o = q_o
        return self


class Permutation:
    """Per-variable wire-occurrence lists -> sigma permutations.

    ``permutation/mod.rs:26-178``.  Slot 0 holds the always-zero variable
    (slot 1 is reserved as in the reference); variable i lives at slot i+2.
    """

    def __init__(self):
        self.slots: List[List[Tuple[int, int]]] = [[], []]

    def new_variable(self) -> int:
        var = len(self.slots) - 2
        self.slots.append([])
        return var

    def _slot(self, var: int) -> int:
        return 0 if var == ZERO else var + 2

    def add_variables_to_map(self, w_l: int, w_r: int, w_o: int, gate: int):
        self.slots[self._slot(w_l)].append((_L, gate))
        self.slots[self._slot(w_r)].append((_R, gate))
        self.slots[self._slot(w_o)].append((_O, gate))

    def compute_sigma_permutations(self, n: int):
        sigmas = [
            [(_L, i) for i in range(n)],
            [(_R, i) for i in range(n)],
            [(_O, i) for i in range(n)],
        ]
        for occurrences in self.slots:
            m = len(occurrences)
            for j, (kind, gate) in enumerate(occurrences):
                nxt = occurrences[(j + 1) % m]
                sigmas[kind][gate] = nxt
        return sigmas

    def compute_all_sigma_evals(self, n: int, roots: List[int], p: int):
        """sigma evals over roots x {1, K1, K2} (``mod.rs:136-177``)."""
        sigmas = self.compute_sigma_permutations(n)
        ks = (1, K1, K2)
        out = []
        for sigma in sigmas:
            out.append([ks[kind] * roots[gate] % p for kind, gate in sigma])
        return out


class SetupComposer:
    """Records selectors + permutation + PI positions (no witness)."""

    def __init__(self, p: int):
        self.p = p
        self.n = 0
        self.q_m: List[int] = []
        self.q_l: List[int] = []
        self.q_r: List[int] = []
        self.q_o: List[int] = []
        self.q_c: List[int] = []
        self.q_lookup: List[int] = []
        self.perm = Permutation()
        self.pp: List[int] = []  # sorted PI gate positions

    def gate_constrain(self, w_l: int, w_r: int, w_o: int, sels: Selectors, with_pi: bool):
        self.q_m.append(sels.q_m)
        self.q_l.append(sels.q_l)
        self.q_r.append(sels.q_r)
        self.q_o.append(sels.q_o)
        self.q_c.append(sels.q_c)
        self.q_lookup.append(sels.q_lookup)
        self.perm.add_variables_to_map(w_l, w_r, w_o, self.n)
        if with_pi:
            self.pp.append(self.n)
        self.n += 1

    def pad_to(self, n: int):
        assert n >= self.n and (n & (n - 1)) == 0
        pad = n - self.n
        for col in (self.q_m, self.q_l, self.q_r, self.q_o, self.q_c, self.q_lookup):
            col.extend([0] * pad)
