"""Prover/verifier key structures, with the key tables as torch tensors.

Same contents as ``zkt_plonk_tpu/proof_system/keys.py`` (reference
``plonk-core/src/proof_system/keys/mod.rs``): the ProverKey holds
coefficient-form polynomials, the ExtendedProverKey the interleaved 4n
coset evaluation tables (plus the inverse of zh on the coset), and the
VerifierKey the 10 commitments and the PI positions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

POLY_ORDER = [
    "q_m",
    "q_l",
    "q_r",
    "q_o",
    "q_c",
    "sigma1",
    "sigma2",
    "sigma3",
    "q_lookup",
    "q_table",
]


@dataclass(eq=False)
class ProverKey:
    """Coefficient-form selector/sigma/table polys: dict name -> (n, L)."""

    n: int
    polys: Dict[str, torch.Tensor]

    def stacked(self, names) -> torch.Tensor:
        return torch.stack([self.polys[k] for k in names])


@dataclass(eq=False)
class ExtendedProverKey:
    """Precomputed 4n-coset tables (INTERLEAVED layout) + n-domain evals.

    Coset tables are (4, n, L): entry [j][k] = value at the coset point
    g*w4n^j*w_n^k (global 4n index 4k+j) — see ``ops/ntt.coset4_fft``.
    """

    n: int
    coset: Dict[str, torch.Tensor]  # name -> (4, n, L) interleaved coset evals
    x_coset: torch.Tensor  # (4, n, L)
    zh_coset_inv: torch.Tensor  # (4, L) — zh on the coset depends only on j
    l1_coset: torch.Tensor  # (4, n, L)
    sigma_evals: torch.Tensor  # (3, n, L) evaluation-form sigmas
    roots: torch.Tensor  # (n, L) domain elements
    q_lookup_evals_host: List[int]  # n ints (0/1)


@dataclass(eq=False)
class VerifierKey:
    """Host-side circuit description for the verifier + transcript seeding."""

    n: int
    pi_pos: List[int]
    commitments: Dict[str, Optional[Tuple[int, int]]]  # name -> affine/None
    domain_gen: int

    def pi_roots(self, p: int) -> List[int]:
        return [pow(self.domain_gen, i, p) for i in self.pi_pos]

    def seed_transcript(self, transcript):
        transcript.append_u64("circuit_size", self.n)
        for name in POLY_ORDER:
            transcript.append_commitment(f"{name}_commit", self.commitments[name])
