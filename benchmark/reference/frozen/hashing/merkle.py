"""Merkle proof-of-existence gadget (circuit).

Rebuild of ``plonk-hashing/src/merkle/binary.rs``: a chain of
conditional-selects + hash_two up the tree; the PoE circuit assigns the
path booleans from the leaf index and returns (root, position bits).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

from ..cs.system import Boolean, ConstraintSystem
from ..cs.variable import LTVariable, lt
from .poseidon.spec import Poseidon


def merkle_proof(
    hasher: Poseidon,
    cs: ConstraintSystem,
    path_elements: Sequence[Tuple[Boolean, LTVariable]],
    leaf_node: LTVariable,
) -> List[LTVariable]:
    """Circuit: fold (is_left, node) pairs into the running hash."""
    cur = leaf_node
    out = []
    for is_left, node_hash in path_elements:
        left = cs.conditional_select(is_left, node_hash, cur)
        right = cs.conditional_select(is_left, cur, node_hash)
        cur = hasher.hash_two(cs, lt(left), lt(right))
        out.append(cur)
    return out


@dataclass
class PoECircuit:
    """Proof-of-existence sub-circuit (``binary.rs:35-79``)."""

    height: int
    leaf_index: int = 0
    path_elements: List[int] = field(default_factory=list)

    def synthesize(
        self, cs: ConstraintSystem, hasher: Poseidon, leaf_node: LTVariable
    ) -> Tuple[LTVariable, List[Boolean]]:
        if not self.path_elements:
            self.path_elements = [0] * self.height
        assert len(self.path_elements) == self.height

        positions = []
        for layer in range(self.height):
            bit = (self.leaf_index >> layer) & 1
            var = cs.assign_variable(bit)
            positions.append(cs.boolean_gate(var))

        witness = [
            (pos, lt(cs.assign_variable(node)))
            for pos, node in zip(positions, self.path_elements)
        ]
        paths = merkle_proof(hasher, cs, witness, leaf_node)
        return paths[-1], positions
