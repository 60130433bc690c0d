"""The withdraw proof at the size its users run (reference
``bin/src/instance.rs:41`` default: HEIGHT=48, NOTE_INPUTS=3,
TABLE_SIZE=1024, Poseidon BN254 width 4), with deterministic data.

``curve="bls12_381"`` builds the same circuit over BLS12-381's scalar
field, the shape of the reference ``bin`` built with its ``bls12-381``
feature (``bin/src/instance.rs:7-15``): Poseidon width 4 with constants
generated for that field by ``PoseidonConstants.generate`` (8 full and 56
partial rounds, as BN254's baked instance), and that field's modulus for
the secrets and their inverses.

Same construction as ``scripts/bench_withdraw.py:build`` of the JAX package:
notes with random identifiers, secrets and amounts are inserted into a
Merkle tree, and the circuit withdraws 120 from their sum.
"""

from __future__ import annotations

import random

from ..cs import LookupTable
from ..fields import BLS12_381_FR, BN254_FR
from ..gadgets.merkle_tree import MerkleTree, MerkleTreeStore
from ..hashing import Poseidon, PoseidonConstants, bn254_constants
from ..hashing.merkle import PoECircuit
from .withdraw import WithdrawCircuit


def build(height: int = 48, notes: int = 3, table_size: int = 1024, seed: int = 7,
          curve: str = "bn254"):
    """Returns (circuit, lookup table, public inputs)."""
    if curve == "bn254":
        P = BN254_FR.modulus
        const = bn254_constants(4)
    elif curve == "bls12_381":
        P = BLS12_381_FR.modulus
        const = PoseidonConstants.generate(P, 4, 255)
    else:
        raise ValueError(f"no withdraw instance for curve {curve!r}")
    hasher = Poseidon(const, native=True)
    rng = random.Random(seed)

    identifiers = [rng.randrange(1, 1 << 160) for _ in range(notes)]
    table = LookupTable(identifiers, size=table_size)
    tree = MerkleTree(hasher, MerkleTreeStore(height=height))
    secrets = [rng.randrange(1, P) for _ in range(notes)]
    amounts = [1000 + 17 * i for i in range(notes)]

    leaf_indices = []
    for ident, amount, secret in zip(identifiers, amounts, secrets):
        commitment = hasher.hash(None, [secret])
        leaf = hasher.hash(None, [ident, amount, commitment])
        leaf_indices.append(tree.add_leaf(leaf))

    withdraw_amount = 120
    new_secret = rng.randrange(1, P)
    new_identifier = identifiers[0]
    amount_out = sum(amounts) - withdraw_amount
    new_commitment = hasher.hash(None, [new_secret])
    new_leaf = hasher.hash(None, [new_identifier, amount_out, new_commitment])
    nullifiers = [hasher.hash(None, [pow(s, -1, P)]) for s in secrets]

    circuit = WithdrawCircuit(
        constants=const,
        height=height,
        secrets=secrets,
        identifiers=identifiers,
        amount_inputs=amounts,
        poe_circuits=[
            PoECircuit(height=height, leaf_index=i, path_elements=tree.merkle_path(i))
            for i in leaf_indices
        ],
        root=tree.root,
        new_secret=new_secret,
        new_identifier=new_identifier,
        withdraw_amount=withdraw_amount,
    )
    pub_inputs = [tree.root] + nullifiers + [withdraw_amount, new_identifier, new_leaf]
    return circuit, table, pub_inputs
