"""Proof structure and host-side verification.

Rebuild of ``plonk-core/src/proof_system/proof.rs:30-503``: transcript
replay, the r0 constant term (PI Lagrange sum + eval terms), the 13-point
linearization commitment MSM, and two batched KZG pairing checks at xi and
omega*xi.  All O(small) — host Python ints are the right tool here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..commitment import kzg
from ..cs.composer import K1, K2
from ..curves import curve_host as ch
from .keys import VerifierKey


from ..errors import ProofVerificationError

# Back-compat alias: the canonical class lives in the errors taxonomy
# (reference ``error.rs:15-87`` role).
VerificationError = ProofVerificationError


@dataclass
class ProofEvaluations:
    """The 12 scalar openings carried by a proof (``proof.rs:29-92``)."""

    a: int
    b: int
    c: int
    sigma1: int
    sigma2: int
    z1_next: int
    q_lookup: int
    t: int
    t_next: int
    z2_next: int
    h1_next: int
    h2: int

    def transcript_items(self):
        return [
            ("a_eval", self.a),
            ("b_eval", self.b),
            ("c_eval", self.c),
            ("sigma1_eval", self.sigma1),
            ("sigma2_eval", self.sigma2),
            ("z1_next_eval", self.z1_next),
            ("q_lookup_eval", self.q_lookup),
            ("t_eval", self.t),
            ("t_next_eval", self.t_next),
            ("z2_next_eval", self.z2_next),
            ("h1_next_eval", self.h1_next),
            ("h2_eval", self.h2),
        ]


Point = Optional[Tuple[int, int]]


@dataclass
class Proof:
    a_commit: Point
    b_commit: Point
    c_commit: Point
    t_commit: Point
    h1_commit: Point
    h2_commit: Point
    z1_commit: Point
    z2_commit: Point
    q_lo_commit: Point
    q_mid_commit: Point
    q_hi_commit: Point
    aw_opening: Point
    saw_opening: Point
    evaluations: ProofEvaluations

    # ------------------------------------------------------------------

    def verify(
        self,
        cvk: kzg.VerifierKeyKZG,
        vk: VerifierKey,
        transcript,
        pub_inputs: List[int],
        p: int,
    ) -> None:
        """Raises VerificationError on failure (``proof.rs:285-503``)."""
        n = vk.n
        assert len(pub_inputs) == len(vk.pi_pos), "invalid length of public inputs"

        transcript.append_scalars("pi", [v % p for v in pub_inputs])

        transcript.append_commitment("a_commit", self.a_commit)
        transcript.append_commitment("b_commit", self.b_commit)
        transcript.append_commitment("c_commit", self.c_commit)
        transcript.append_commitment("t_commit", self.t_commit)
        transcript.append_commitment("h1_commit", self.h1_commit)
        transcript.append_commitment("h2_commit", self.h2_commit)

        beta = transcript.challenge_scalar("beta")
        gamma = transcript.challenge_scalar("gamma")
        delta = transcript.challenge_scalar("delta")
        epsilon = transcript.challenge_scalar("epsilon")
        assert len({beta, gamma, delta, epsilon}) == 4, "challenges must be different"

        transcript.append_commitment("z1_commit", self.z1_commit)
        transcript.append_commitment("z2_commit", self.z2_commit)
        alpha = transcript.challenge_scalar("alpha")

        transcript.append_commitment("q_lo_commit", self.q_lo_commit)
        transcript.append_commitment("q_mid_commit", self.q_mid_commit)
        transcript.append_commitment("q_hi_commit", self.q_hi_commit)
        xi = transcript.challenge_scalar("xi")

        zh_eval = (pow(xi, n, p) - 1) % p
        l1_eval = zh_eval * pow(n * (xi - 1) % p, -1, p) % p

        r0 = self._compute_r0(
            alpha, beta, gamma, delta, epsilon, xi, l1_eval, zh_eval, pub_inputs, vk, p
        )
        r_commit = self._linearization_commitment(
            alpha, beta, gamma, delta, epsilon, xi, l1_eval, zh_eval, vk, cvk, p
        )

        for label, value in self.evaluations.transcript_items():
            transcript.append_scalar(label, value)

        eta = transcript.challenge_scalar("eta")
        ev = self.evaluations

        # scheme-dispatched batch-opening checks (reference ``PC::check``,
        # ``proof.rs:441-501``): KZG = pairing equations, IPA = folding
        # argument verification.
        from ..commitment import scheme as scheme_mod

        pc = scheme_mod.for_key(cvk)
        ok1 = pc.check_batch(
            cvk,
            [
                r_commit,
                self.a_commit,
                self.b_commit,
                self.c_commit,
                vk.commitments["sigma1"],
                vk.commitments["sigma2"],
                vk.commitments["q_lookup"],
                self.t_commit,
                self.h2_commit,
            ],
            xi,
            [r0, ev.a, ev.b, ev.c, ev.sigma1, ev.sigma2, ev.q_lookup, ev.t, ev.h2],
            self.aw_opening,
            eta,
            b"aw",
        )
        if not ok1:
            raise VerificationError(1)

        wxi = xi * vk.domain_gen % p
        ok2 = pc.check_batch(
            cvk,
            [self.z1_commit, self.z2_commit, self.t_commit, self.h1_commit],
            wxi,
            [ev.z1_next, ev.z2_next, ev.t_next, ev.h1_next],
            self.saw_opening,
            eta,
            b"saw",
        )
        if not ok2:
            raise VerificationError(2)

    # ------------------------------------------------------------------

    def _compute_r0(
        self, alpha, beta, gamma, delta, epsilon, xi, l1_eval, zh_eval, pub_inputs, vk, p
    ) -> int:
        ev = self.evaluations
        alpha_sq = alpha * alpha % p

        # PI(xi): -Σ L_i(xi) pi_i over the PI positions (``proof.rs:178-192``)
        part1 = 0
        for pi, root in zip(pub_inputs, vk.pi_roots(p)):
            lagrange = zh_eval * root % p * pow(vk.n * (xi - root) % p, -1, p) % p
            part1 = (part1 + lagrange * pi) % p
        part1 = (-part1) % p

        part2 = (
            alpha
            * ev.z1_next
            * ((ev.a + beta * ev.sigma1 + gamma) % p)
            * ((ev.b + beta * ev.sigma2 + gamma) % p)
            * ((ev.c + gamma) % p)
        ) % p

        part3 = l1_eval * alpha_sq % p

        eps_1pd = epsilon * (1 + delta) % p
        part4 = (
            alpha_sq
            * alpha
            * ev.z2_next
            * ((eps_1pd + delta * ev.h2) % p)
            * ((eps_1pd + ev.h2 + delta * ev.h1_next) % p)
        ) % p

        part5 = l1_eval * pow(alpha_sq, 2, p) % p

        return (part1 + part2 + part3 + part4 + part5) % p

    def _linearization_commitment(
        self, alpha, beta, gamma, delta, epsilon, xi, l1_eval, zh_eval, vk, cvk, p
    ):
        """13-point host MSM (``proof.rs:220-282`` + widget VK methods)."""
        ev = self.evaluations
        ctx = cvk.ctx
        Fq = ctx.Fq

        def to_pt(c):
            return None if c is None else (Fq(c[0]), Fq(c[1]))

        scalars: List[int] = []
        points: List = []

        # arithmetic (``keys/arithmetic.rs:116-136``)
        scalars += [ev.a * ev.b % p, ev.a, ev.b, ev.c, 1]
        points += [
            to_pt(vk.commitments["q_m"]),
            to_pt(vk.commitments["q_l"]),
            to_pt(vk.commitments["q_r"]),
            to_pt(vk.commitments["q_o"]),
            to_pt(vk.commitments["q_c"]),
        ]

        # permutation (``keys/permutation.rs:167-196``)
        beta_xi = beta * xi % p
        scalars.append(
            (
                alpha
                * ((beta_xi + ev.a + gamma) % p)
                * ((beta_xi * K1 + ev.b + gamma) % p)
                * ((beta_xi * K2 + ev.c + gamma) % p)
                + l1_eval * alpha * alpha
            )
            % p
        )
        points.append(to_pt(self.z1_commit))
        scalars.append(
            (
                -alpha
                * beta
                * ev.z1_next
                * ((beta * ev.sigma1 + ev.a + gamma) % p)
                * ((beta * ev.sigma2 + ev.b + gamma) % p)
            )
            % p
        )
        points.append(to_pt(vk.commitments["sigma3"]))

        # lookup (``keys/lookup.rs:150-186``)
        alpha_cu = pow(alpha, 3, p)
        alpha_qu = pow(alpha, 4, p)
        one_plus_delta = (1 + delta) % p
        eps_1pd = epsilon * one_plus_delta % p
        scalars.append(
            (
                alpha_cu
                * one_plus_delta
                * ((epsilon + ev.q_lookup * ev.c) % p)
                * ((eps_1pd + ev.t + delta * ev.t_next) % p)
                + alpha_qu * l1_eval
            )
            % p
        )
        points.append(to_pt(self.z2_commit))
        scalars.append(
            (-alpha_cu * ev.z2_next * ((eps_1pd + ev.h2 + delta * ev.h1_next) % p)) % p
        )
        points.append(to_pt(self.h1_commit))
        scalars.append(alpha_qu * alpha % p * ev.t % p)
        points.append(to_pt(vk.commitments["q_table"]))

        # quotient pieces (``proof.rs:270-279``)
        xi_n2 = (zh_eval + 1) * xi * xi % p
        scalars.append((-zh_eval) % p)
        points.append(to_pt(self.q_lo_commit))
        scalars.append((-zh_eval) * xi_n2 % p)
        points.append(to_pt(self.q_mid_commit))
        scalars.append((-zh_eval) * xi_n2 % p * xi_n2 % p)
        points.append(to_pt(self.q_hi_commit))

        result = ch.msm(points, scalars)
        return None if result is None else (int(result[0]), int(result[1]))
