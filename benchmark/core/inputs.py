"""The deployment of one run, made from ``--seed``.

For a configuration and a traffic mix it draws

* tau, the SRS trapdoor (the port's ``kzg.setup`` and the reference take it);
* a lookup table of ``table_size`` distinct 20-byte identifiers;
* ``pool * note_inputs`` deposited notes (identifier from the table, an
  amount, a secret), their leaves in a tree of height ``height``;
* ``pool`` distinct withdraw requests, each spending its own
  ``note_inputs`` notes, with a fresh new secret and the traffic's amount,
  and the public inputs the proof has to bind:
  [root, nullifiers, amount, new identifier, new leaf].

Every hash is the benchmark's frozen host Poseidon; the program receives
only the finished values.  The tree is built level by level (the leaves
are the first indices of the sparse tree, every other node is the empty
subtree's hash), the same root and paths as inserting the leaves one by
one into ``MerkleTree``.  The same seed gives the same deployment.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List

from ..reference.frozen.hashing.poseidon.spec import Poseidon
from ..reference.plonk_kzg import CURVES, poseidon_constants

IDENTIFIER_BITS = 160  # an Ethereum address read as a little-endian integer


@dataclass(frozen=True)
class Request:
    secrets: List[int]
    identifiers: List[int]
    amounts: List[int]
    leaf_indices: List[int]
    paths: List[List[int]]
    root: int
    new_secret: int
    new_identifier: int
    withdraw_amount: int
    public_inputs: List[int]


@dataclass(frozen=True)
class Deployment:
    tau: int
    table: List[int]
    requests: List[Request]


def _tree(hasher: Poseidon, leaves: List[int], height: int):
    """(root, levels): levels[l] holds the nodes of level l that are not
    empty subtrees; every other node at level l is empty[l]."""
    empty = [Poseidon.empty_hash()]
    for _ in range(height - 1):
        empty.append(hasher.hash_two(None, empty[-1], empty[-1]))
    levels = [list(leaves)]
    for layer in range(height):
        cur = levels[-1]
        if len(cur) % 2:
            cur = cur + [empty[layer]]
        levels.append([hasher.hash_two(None, cur[i], cur[i + 1]) for i in range(0, len(cur), 2)])
    root = levels[height][0]
    return root, levels[:height], empty


def _path(levels, empty, index: int) -> List[int]:
    out = []
    for layer, nodes in enumerate(levels):
        sib = (index >> layer) ^ 1
        out.append(nodes[sib] if sib < len(nodes) else empty[layer])
    return out


def make(config: dict, traffic: dict, seed: int) -> Deployment:
    curve = CURVES[config["curve"]]
    r = curve.r
    rng = random.Random(f"deployment:{config['name']}:{seed}")
    hasher = Poseidon(poseidon_constants(config["curve"], config["poseidon_width"]), native=True)
    tau = rng.randrange(2, r)
    table: List[int] = []
    seen = set()
    while len(table) < config["table_size"]:
        ident = rng.randrange(1, 1 << IDENTIFIER_BITS)
        if ident not in seen:
            seen.add(ident)
            table.append(ident)

    k, pool, height = config["note_inputs"], traffic["pool"], config["height"]
    amount = traffic["withdraw_amount"]
    notes = []
    for _ in range(pool * k):
        ident = rng.choice(table)
        value = rng.randrange(amount, 1 << 40)  # each request can pay the amount
        secret = rng.randrange(1, r)
        leaf = hasher.hash(None, [ident, value, hasher.hash(None, [secret])])
        notes.append((ident, value, secret, leaf))
    root, levels, empty = _tree(hasher, [n[3] for n in notes], height)

    requests = []
    for j in range(pool):
        idx = list(range(j * k, (j + 1) * k))
        mine = [notes[i] for i in idx]
        new_secret = rng.randrange(1, r)
        new_identifier = rng.choice(table)
        amount_out = sum(n[1] for n in mine) - amount
        nullifiers = [hasher.hash(None, [pow(n[2], -1, r)]) for n in mine]
        new_leaf = hasher.hash(None, [new_identifier, amount_out,
                                      hasher.hash(None, [new_secret])])
        requests.append(Request(
            secrets=[n[2] for n in mine],
            identifiers=[n[0] for n in mine],
            amounts=[n[1] for n in mine],
            leaf_indices=idx,
            paths=[_path(levels, empty, i) for i in idx],
            root=root,
            new_secret=new_secret,
            new_identifier=new_identifier,
            withdraw_amount=amount,
            public_inputs=[root, *nullifiers, amount, new_identifier, new_leaf],
        ))
    return Deployment(tau=tau, table=table, requests=requests)


def proof_rng(seed: int, k: int) -> random.Random:
    """The blinders' randomness of the k-th request a run issues (warm-up
    requests take negative k): fresh for every proof, fixed by the seed."""
    return random.Random(f"proof:{seed}:{k}")
