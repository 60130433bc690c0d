"""Polynomial-commitment scheme dispatch for the proving pipeline.

Role of the reference's ``HomomorphicCommitment`` trait
(``plonk-core/src/commitment.rs:10-21``).  This slice of the port carries
the KZG10 scheme only; ``for_key`` dispatches on the key type so the
pipeline never threads a scheme string through.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from . import kzg

Point = Optional[Tuple[int, int]]


class KZGScheme:
    """SonicKZG10-style batched openings: one W point per opening set."""

    name = "kzg"

    def committer(self, ck: kzg.CommitterKey):
        return kzg.Committer(ck)

    def trim(self, ck, cvk, degree: int):
        return kzg.trim(ck, cvk, degree)

    def max_degree(self, ck) -> int:
        return ck.max_degree

    def open_batch(self, prover, polys, point: int, eta: int, label: bytes):
        """Device eta-fold + synthetic division, then one commit."""
        w = prover.open_batch(polys, point, eta)
        return prover.committer.commit_many(w[None])[0]

    def check_batch(
        self, cvk, commitments: Sequence[Point], point: int,
        values: Sequence[int], opening, eta: int, label: bytes,
    ) -> bool:
        return kzg.check(cvk, commitments, point, values, opening, eta)


_KZG = KZGScheme()


def for_key(key) -> object:
    """Scheme dispatch by committer/verifier key type."""
    if isinstance(key, (kzg.CommitterKey, kzg.VerifierKeyKZG)):
        return _KZG
    raise TypeError(f"unknown polynomial-commitment key type {type(key)!r}")
