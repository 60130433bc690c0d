"""Host-side sparse incremental Merkle tree store.

Rebuild of ``gadgets/src/merkle_tree.rs``: a dict-backed sparse tree with
per-level empty-subtree hashes, incremental ``add_leaf`` and witness-path
extraction.  Serialization to/from a plain dict for checkpointing (the
reference uses ark CanonicalSerialize files — see ``utils/serialize.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from ..hashing.poseidon.spec import Poseidon


@dataclass
class MerkleTreeStore:
    height: int
    tree: Dict[Tuple[int, int], int] = field(default_factory=dict)
    root: int = 0
    next_index: int = 0

    def to_dict(self) -> dict:
        return {
            "height": self.height,
            "tree": [[k[0], k[1], str(v)] for k, v in self.tree.items()],
            "root": str(self.root),
            "next_index": self.next_index,
        }

    @staticmethod
    def from_dict(d: dict) -> "MerkleTreeStore":
        return MerkleTreeStore(
            height=d["height"],
            tree={(int(l), int(i)): int(v) for l, i, v in d["tree"]},
            root=int(d["root"]),
            next_index=d["next_index"],
        )


class MerkleTree:
    """Incremental tree over a native hasher (``merkle_tree.rs:39-111``)."""

    def __init__(self, hasher: Poseidon, store: MerkleTreeStore):
        self.hasher = hasher
        self.store = store
        self.height = store.height
        # per-level empty-subtree hashes
        self.empty_nodes: List[int] = []
        h = Poseidon.empty_hash()
        for _ in range(self.height):
            self.empty_nodes.append(h)
            h = hasher.hash_two(None, h, h)

    def merkle_path(self, index: int) -> List[int]:
        out = []
        for layer in range(self.height):
            idx = index >> layer
            sibling = idx - 1 if idx & 1 else idx + 1
            out.append(self.store.tree.get((layer, sibling), self.empty_nodes[layer]))
        return out

    def add_leaf(self, leaf_hash: int) -> int:
        index = self.store.next_index
        self.store.next_index += 1
        h = leaf_hash
        for layer in range(self.height):
            idx = index >> layer
            self.store.tree[(layer, idx)] = h
            if idx & 1:
                witness = self.store.tree.get((layer, idx - 1), self.empty_nodes[layer])
                h = self.hasher.hash_two(None, witness, h)
            else:
                witness = self.store.tree.get((layer, idx + 1), self.empty_nodes[layer])
                h = self.hasher.hash_two(None, h, witness)
        self.store.root = h
        return index

    @property
    def root(self) -> int:
        return self.store.root
