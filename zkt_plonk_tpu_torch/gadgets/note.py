"""Note model (``gadgets/src/note.rs``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class Note:
    leaf_index: int
    identifier: int
    amount: int
    secret: int

    def to_dict(self) -> dict:
        return {
            "leaf_index": self.leaf_index,
            "identifier": str(self.identifier),
            "amount": self.amount,
            "secret": str(self.secret),
        }

    @staticmethod
    def from_dict(d: dict) -> "Note":
        return Note(
            leaf_index=d["leaf_index"],
            identifier=int(d["identifier"]),
            amount=d["amount"],
            secret=int(d["secret"]),
        )


@dataclass
class Notes:
    notes: List[Note] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {"notes": [n.to_dict() for n in self.notes]}

    @staticmethod
    def from_dict(d: dict) -> "Notes":
        return Notes([Note.from_dict(n) for n in d["notes"]])
