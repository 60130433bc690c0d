"""Polynomial-commitment scheme dispatch for the proving pipeline.

Role of the reference's ``HomomorphicCommitment`` trait
(``plonk-core/src/commitment.rs:10-21``), as in
``zkt_plonk_tpu/commitment/scheme.py``: the PLONK setup, prover and
verifier are generic over KZG10 (``commitment.rs:24-46``) and IPA
(``commitment.rs:49-86``), and ``for_key`` dispatches on the key type so
the pipeline never threads a scheme string through.  Commits run on the
key's device (the MSM kernels on the card, their plain versions on the
CPU); openings and checks of the IPA are host Python.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..fields.limbs import array_to_ints
from ..ops import msm
from ..utils import profiling
from . import ipa, kzg

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


class IPAScheme:
    """Bulletproofs-style inner-product openings (transparent setup)."""

    name = "ipa"

    class _Committer:
        """Commits on the key's device: one batched MSM over its generator
        table as ``msm_points`` (the JAX package chooses by
        ``jax.default_backend()``; here a CUDA key launches the kernels and
        a CPU key runs the plain versions)."""

        def __init__(self, ck: ipa.CommitterKeyIPA):
            self.ck = ck

        def commit_many(self, polys) -> List[Point]:
            if polys[0].shape[0] > len(self.ck.gens):
                raise ValueError("polynomial degree exceeds committer key")
            with profiling.section("commit"):
                return msm.commit_rows(self.ck.ctx, self.ck.b3, self.ck.msm_points, polys)

    def committer(self, ck):
        return IPAScheme._Committer(ck)

    def trim(self, ck, cvk, degree: int):
        if degree > ck.max_degree:
            raise ValueError(
                f"IPA key supports degree {ck.max_degree}, need {degree}"
            )
        return ck, cvk

    def max_degree(self, ck) -> int:
        return ck.max_degree

    def open_batch(self, prover, polys, point: int, eta: int, label: bytes):
        """Host opening: the rows decoded to ints, as in the JAX package."""
        with profiling.waiting():
            rows = polys.cpu().numpy()
        host_polys = [array_to_ints(rows[i]) for i in range(len(rows))]
        proof, _v = ipa.open_batch(prover.ck, host_polys, point, eta, label=label)
        return proof

    def check_batch(
        self, cvk, commitments, point, values, opening, eta, label: bytes
    ) -> bool:
        Fq = cvk.ctx.Fq
        pts = [
            None if c is None else (Fq(c[0]), Fq(c[1])) for c in commitments
        ]
        return ipa.check_batch(cvk, pts, point, list(values), eta, opening, label=label)


_KZG = KZGScheme()
_IPA = IPAScheme()


def for_key(key) -> object:
    """Scheme dispatch by committer/verifier key type."""
    if isinstance(key, (kzg.CommitterKey, kzg.VerifierKeyKZG)):
        return _KZG
    if isinstance(key, ipa.CommitterKeyIPA):
        return _IPA
    raise TypeError(f"unknown polynomial-commitment key type {type(key)!r}")
