"""The 5-round PLONKUP prover — host orchestration around device tensors.

Rebuild of ``plonk-core/src/proof_system/prove.rs:59-483`` (+
``quotient_poly.rs``, ``linearization_poly.rs``, ``permutation/mod.rs``,
``lookup/mod.rs``) with the same rounds, the same blinders drawn in the
same order and the same transcript as ``zkt_plonk_tpu/proof_system/
prover.py``:

* rounds 1+2 commit a/b/c/t/h1/h2 as one batched iNTT and one batched MSM;
* the grand products z1/z2 are log-depth prefix-product scans with one
  batch inversion (a single Fermat inversion, kernel K2);
* the quotient runs on the interleaved 4n coset with the precomputed
  inverse vanishing table;
* the evaluations, the linearization and the two KZG openings follow.

Every device array is an int32 limb tensor on the committer key's device;
round intermediates are dropped as soon as the round's commitments are out.

``RoundSchedule`` holds the host side of a proof (staging, blinders,
challenges, each round's scalars, the linearization) and
``grand_products``/``quotient_evals`` the pointwise arithmetic of rounds 3
and 4; ``Prover`` and ``parallel.ShardedProver`` share them and differ only
in where the rows live.
"""

from __future__ import annotations

from typing import List

import torch

from ..cs.composer import K1, K2, ProvingComposer
from ..cs.lookup import LookupTable, combine_split
from ..fields import device as fd
from ..ops import ntt
from ..utils.domain import make_domain
from ..utils.profiling import section, waiting
from ..utils.scan import tree_reduce
from .keys import ExtendedProverKey, ProverKey, VerifierKey
from .proof import Proof, ProofEvaluations

PK_NAMES = ("sigma1", "sigma2", "sigma3", "q_lookup", "q_table",
            "q_m", "q_l", "q_r", "q_o", "q_c")


def _pad4(x: torch.Tensor) -> torch.Tensor:
    """Pad the polynomial axis (-2) with 4 zero coefficients."""
    return torch.nn.functional.pad(x, (0, 0, 0, 4))


class LocalRows:
    """The operations of the rounds along the domain's row axis (-2) when a
    tensor holds all n rows; ``parallel.prover.ShardedRows`` does them on a
    mesh's row blocks."""

    holds_row0 = True

    @staticmethod
    def roll(x: torch.Tensor, shift: int) -> torch.Tensor:
        return torch.roll(x, shift, dims=-2)

    @staticmethod
    def batch_inverse(spec, x: torch.Tensor) -> torch.Tensor:
        """(B, n, L): one batch inversion over all B*n values."""
        return fd.batch_inverse(spec, x.reshape(-1, x.shape[-1]), axis=0).reshape(x.shape)

    @staticmethod
    def prefix_products(spec, x: torch.Tensor) -> torch.Tensor:
        return fd.prefix_products(spec, x, axis=-2)


def grand_products(spec, rows, wires, f, t, h1, h2, roots, sigmas, scalars) -> torch.Tensor:
    """Evaluations of z1 (permutation) and z2 (lookup), (2, rows, L), on the
    rows that ``rows`` (``LocalRows`` or a sharded counterpart) holds.

    scalars: (8, L) [beta, beta*K1, beta*K2, gamma, delta, eps(1+d),
    1+delta, epsilon]."""
    a, b, c = wires[0], wires[1], wires[2]
    s1, s2, s3 = sigmas[0], sigmas[1], sigmas[2]
    beta, bk1, bk2, gamma, delta, eps_1pd, one_pd, epsilon = scalars.unbind(0)
    t_next = rows.roll(t, -1)
    h1_next = rows.roll(h1, -1)

    lhs1 = torch.stack([roots, roots, roots, s1, s2, s3, t_next, h2, h1_next])
    rhs1 = torch.stack([beta, bk1, bk2, beta, beta, beta, delta, delta, delta])[:, None]
    bx, bx1, bx2, bs1, bs2, bs3, dtn, dh2, dh1n = fd.mul(spec, lhs1, rhs1).unbind(0)

    ad = lambda x, y: fd.add(spec, x, y)
    num1 = ad(ad(bx, a), gamma)
    num2 = ad(ad(bx1, b), gamma)
    num3 = ad(ad(bx2, c), gamma)
    den1 = ad(ad(bs1, a), gamma)
    den2 = ad(ad(bs2, b), gamma)
    den3 = ad(ad(bs3, c), gamma)
    t2f = ad(ad(dtn, eps_1pd), t)
    epf = ad(epsilon, f)
    zd1 = ad(ad(dh2, eps_1pd), h1)
    zd2 = ad(ad(dh1n, eps_1pd), h2)

    p2 = fd.mul(spec, torch.stack([num1, den1, epf, zd1]), torch.stack([num2, den2, t2f, zd2]))
    p3 = fd.mul(
        spec,
        p2[:3],
        torch.stack([num3, den3, one_pd.expand_as(num3)]),
    )
    z1_num, z1_den, z2_num = p3.unbind(0)
    z2_den = p2[3]

    dens_inv = rows.batch_inverse(spec, torch.stack([z1_den, z2_den]))
    ratios = fd.mul(spec, torch.stack([z1_num, z2_num]), dens_inv)
    shifted = rows.roll(ratios, 1)
    if rows.holds_row0:
        shifted[:, 0] = fd.one(spec, (), device=shifted.device)
    return rows.prefix_products(spec, shifted)


def quotient_evals(spec, rows, cs, coset, x_coset, l1_coset, zh_coset_inv, sc, weights):
    """The quotient's values on the interleaved 4n coset, (4, rows, L), from
    the coset values cs (9, 4, rows, L) of [a,b,c,z1,z2,t,h1,h2,pi]; "next"
    taps (+4 on the 4n coset) are +1 rolls inside each subdomain.

    sc: (7, L) [beta, beta*K1, beta*K2, gamma, delta, epsilon, eps(1+d)];
    weights: (7, L) [alpha, alpha, a3(1+d), a3, a^2, a^4, a^5]."""
    one = fd.one(spec, (), device=cs.device)
    a, b, c, z1, z2, t, h1, h2, pi = cs.unbind(0)
    z1n = rows.roll(z1, -1)
    z2n = rows.roll(z2, -1)
    tn = rows.roll(t, -1)
    h1n = rows.roll(h1, -1)

    ad = lambda x, y: fd.add(spec, x, y)
    sb = lambda x, y: fd.sub(spec, x, y)
    beta, bk1, bk2, gamma, delta, epsilon, eps_1pd = sc.unbind(0)
    x4, c4 = x_coset, coset

    def bc(s):
        return s.expand_as(a)

    p1 = fd.mul(
        spec,
        torch.stack([a, x4, x4, x4, c4["sigma1"], c4["sigma2"], c4["sigma3"],
                     c4["q_lookup"], tn, h2, h1n]),
        torch.stack([b, bc(beta), bc(bk1), bc(bk2), bc(beta), bc(beta), bc(beta),
                     c, bc(delta), bc(delta), bc(delta)]),
    )
    ab, bx, bx1, bx2, bs1, bs2, bs3, qlc, dtn, dh2, dh1n = p1.unbind(0)
    del p1

    p2 = fd.mul(
        spec,
        torch.stack([ab, a, b, c,
                     ad(ad(bx, a), gamma), ad(ad(bs1, a), gamma),
                     ad(ad(eps_1pd, t), dtn), ad(ad(eps_1pd, h1), dh2),
                     c4["q_table"], sb(z1, one), sb(z2, one)]),
        torch.stack([c4["q_m"], c4["q_l"], c4["q_r"], c4["q_o"],
                     ad(ad(bx1, b), gamma), ad(ad(bs2, b), gamma),
                     ad(epsilon, qlc), ad(ad(eps_1pd, h2), dh1n),
                     t, l1_coset, l1_coset]),
    )
    abqm, aql, bqr, cqo, p1a, p2a, tq, hh, qtt, l1z1, l1z2 = p2.unbind(0)
    del p2

    p3 = fd.mul(
        spec,
        torch.stack([p1a, p2a]),
        torch.stack([ad(ad(bx2, c), gamma), ad(ad(bs3, c), gamma)]),
    )
    p4 = fd.mul(
        spec,
        torch.stack([z1, z1n, z2, z2n]),
        torch.stack([p3[0], p3[1], tq, hh]),
    )
    p5 = fd.mul(
        spec,
        torch.stack([p4[0], p4[1], p4[2], p4[3], l1z1, l1z2, qtt]),
        weights[:, None, None, :],
    )
    del p3, p4, cs

    arith = ad(ad(ad(abqm, aql), ad(bqr, cqo)), ad(c4["q_c"], pi))
    perm = ad(sb(p5[0], p5[1]), p5[4])
    lookup = ad(ad(sb(p5[2], p5[3]), p5[5]), p5[6])
    del p5

    # zh on the coset depends only on the subdomain j: (4, L) scalars
    return fd.mul(spec, ad(ad(arith, perm), lookup), zh_coset_inv[:, None, :])


class RoundSchedule:
    """The host side of a proof, shared by ``Prover`` and
    ``parallel.ShardedProver``: the witness and its staging, the blinders in
    their order, the transcript's challenges, each round's scalars and the
    linearization.

    A subclass sets ``n``, ``p``, ``spec``, ``device``, ``domain``, ``epk``,
    ``t_ints``, ``t_dev``, ``pk_padded`` and ``row_block`` (the rows of the
    domain it holds) and gives the device rounds (``commit_batch``,
    ``commit_many``, ``z_round``, ``quotient_round``, ``evaluate``,
    ``linearize``, ``openings``) and ``stack``, which stacks polynomials of
    its batches as ``torch.stack`` does (a batch indexes its polynomials as
    a (B, n+4, L) tensor does)."""

    stack = staticmethod(torch.stack)

    # ------------------------------------------------------------------
    # host <-> device staging
    # ------------------------------------------------------------------

    def rows(self, ints: List[int]) -> torch.Tensor:
        """This prover's rows of n host ints -> (rows, L) int32 tensor."""
        return self.stack_rows([ints])[0]

    def stack_rows(self, cols) -> torch.Tensor:
        """This prover's rows of k columns of n host ints -> (k, rows, L)."""
        lo, hi = self.row_block
        with section("stage"):
            return fd.upload(self.spec.n_limbs, [col[lo:hi] for col in cols], self.device)

    def vec(self, vals: List[int]) -> torch.Tensor:
        """Host scalars -> (k, L) int32 tensor on the device."""
        with section("stage"):
            return fd.upload(self.spec.n_limbs, [[v % self.p for v in vals]], self.device)[0]

    def blinders(self, rng, counts: List[int]) -> torch.Tensor:
        """(len(counts), 4, L): row i holds counts[i] random scalars, then zeros."""
        with section("stage"):
            rows = []
            for k in counts:
                rows.append([rng.randrange(self.p) for _ in range(k)] + [0] * (4 - k))
            return fd.upload(self.spec.n_limbs, rows, self.device)

    # ------------------------------------------------------------------
    # host orchestration
    # ------------------------------------------------------------------

    def prove(self, composer: ProvingComposer, transcript, rng) -> Proof:
        with section("prove"):
            return self._prove(composer, transcript, rng)

    def _prove(self, composer: ProvingComposer, transcript, rng) -> Proof:
        n, p, spec = self.n, self.p, self.spec
        composer.pad_to(n)

        # PI to transcript (``prove.rs:110``)
        transcript.append_scalars("pi", composer.pi_values())

        # --- round 1: wire polynomials --------------------------------
        with section("witness"):
            a_ints, b_ints, c_ints = composer.wire_evals()
        wires = self.stack_rows([a_ints, b_ints, c_ints])
        wire_blinders = self.blinders(rng, [2, 2, 2])

        # --- round 2 witness ------------------------------------------
        with section("lookup_sort"):
            ql = self.epk.q_lookup_evals_host
            f_ints = [(ql[i] * c_ints[i]) % p for i in range(n)]
            h1_ints, h2_ints = combine_split(self.t_ints, f_ints)
            h1_ints += [0] * (n - len(h1_ints))
            h2_ints += [0] * (n - len(h2_ints))
        lookup_evals = torch.cat([self.t_dev[None], self.stack_rows([h1_ints, h2_ints])])
        lookup_blinders = self.blinders(rng, [0, 3, 2])

        # rounds 1+2 as one phase: 6-poly iNTT batch + 6-MSM batch
        with section("round1+2"):
            six_polys = self.commit_batch(
                torch.cat([wires, lookup_evals]), torch.cat([wire_blinders, lookup_blinders])
            )
            six_aff = self.commit_many(six_polys)
        abc_polys, th_polys = six_polys[:3], six_polys[3:]
        abc_aff, th_aff = six_aff[:3], six_aff[3:]
        transcript.append_commitment("a_commit", abc_aff[0])
        transcript.append_commitment("b_commit", abc_aff[1])
        transcript.append_commitment("c_commit", abc_aff[2])
        transcript.append_commitment("t_commit", th_aff[0])
        transcript.append_commitment("h1_commit", th_aff[1])
        transcript.append_commitment("h2_commit", th_aff[2])

        # --- round 3: grand products ----------------------------------
        beta = transcript.challenge_scalar("beta")
        gamma = transcript.challenge_scalar("gamma")
        delta = transcript.challenge_scalar("delta")
        epsilon = transcript.challenge_scalar("epsilon")
        assert len({beta, gamma, delta, epsilon}) == 4, "challenges must be different"

        z_blinders = self.blinders(rng, [3, 3])
        eps_1pd = epsilon * (1 + delta) % p
        z_scalars = self.vec(
            [beta, beta * K1 % p, beta * K2 % p, gamma, delta, eps_1pd, (1 + delta) % p, epsilon]
        )
        with section("round3"):
            z_polys = self.z_round(
                wires, self.rows(f_ints), lookup_evals[0], lookup_evals[1], lookup_evals[2],
                z_scalars, z_blinders,
            )
            del wires, lookup_evals
            z_aff = self.commit_many(z_polys)
        transcript.append_commitment("z1_commit", z_aff[0])
        transcript.append_commitment("z2_commit", z_aff[1])

        # --- round 4: quotient ----------------------------------------
        alpha = transcript.challenge_scalar("alpha")
        pi_evals = self.rows(composer.pi_as_evals(n))
        polys8 = self.stack(
            [abc_polys[0], abc_polys[1], abc_polys[2], z_polys[0], z_polys[1],
             th_polys[0], th_polys[1], th_polys[2]]
        )
        q_blinders = self.vec([rng.randrange(p), rng.randrange(p)])
        a2 = alpha * alpha % p
        a3 = a2 * alpha % p
        a4 = a3 * alpha % p
        a5 = a4 * alpha % p
        q_scalars = self.vec([beta, beta * K1 % p, beta * K2 % p, gamma, delta, epsilon, eps_1pd])
        q_weights = self.vec([alpha, alpha, a3 * (1 + delta) % p, a3, a2, a4, a5])
        with section("round4"):
            q_polys = self.quotient_round(polys8, pi_evals, q_scalars, q_weights, q_blinders)
            del polys8
            q_aff = self.commit_many(q_polys)
        transcript.append_commitment("q_lo_commit", q_aff[0])
        transcript.append_commitment("q_mid_commit", q_aff[1])
        transcript.append_commitment("q_hi_commit", q_aff[2])

        # --- round 5: evaluations + linearization ---------------------
        xi = transcript.challenge_scalar("xi")
        wxi = xi * self.domain.group_gen % p
        pkp = self.pk_padded

        polys_xi = self.stack(
            [abc_polys[0], abc_polys[1], abc_polys[2], pkp["sigma1"], pkp["sigma2"],
             pkp["q_lookup"], th_polys[0], th_polys[2]]
        )
        polys_wxi = self.stack([z_polys[0], th_polys[0], z_polys[1], th_polys[1]])  # z1, t, z2, h1
        with section("round5"):
            ev_xi, ev_wxi = self.evaluate(polys_xi, polys_wxi, xi, wxi)
            with waiting():
                ev_xi_host = ev_xi.cpu().numpy()
            with waiting():
                ev_wxi_host = ev_wxi.cpu().numpy()
            ev_xi_i = spec.decode(ev_xi_host)
            ev_wxi_i = spec.decode(ev_wxi_host)

        evals = ProofEvaluations(
            a=ev_xi_i[0],
            b=ev_xi_i[1],
            c=ev_xi_i[2],
            sigma1=ev_xi_i[3],
            sigma2=ev_xi_i[4],
            z1_next=ev_wxi_i[0],
            q_lookup=ev_xi_i[5],
            t=ev_xi_i[6],
            t_next=ev_wxi_i[1],
            z2_next=ev_wxi_i[2],
            h1_next=ev_wxi_i[3],
            h2=ev_xi_i[7],
        )
        for label, value in evals.transcript_items():
            transcript.append_scalar(label, value)

        zh_eval = (pow(xi, n, p) - 1) % p
        l1_eval = zh_eval * pow(n * (xi - 1) % p, -1, p) % p
        with section("linearization_terms"):
            scalars, poly_list = self._linearization_terms(
                evals, alpha, beta, gamma, delta, epsilon, xi, zh_eval, l1_eval,
                pkp, abc_polys, z_polys, th_polys, q_polys,
            )
        with section("linearization"):
            r_poly = self.linearize(self.stack(poly_list), self.vec(scalars))

        # --- openings --------------------------------------------------
        eta = transcript.challenge_scalar("eta")
        aw_polys = self.stack(
            [r_poly, abc_polys[0], abc_polys[1], abc_polys[2], pkp["sigma1"], pkp["sigma2"],
             pkp["q_lookup"], th_polys[0], th_polys[2]]
        )
        saw_polys = self.stack([z_polys[0], z_polys[1], th_polys[0], th_polys[1]])
        with section("openings"):
            aw_aff, saw_aff = self.openings(aw_polys, xi, saw_polys, wxi, eta)

        return Proof(
            a_commit=abc_aff[0],
            b_commit=abc_aff[1],
            c_commit=abc_aff[2],
            t_commit=th_aff[0],
            h1_commit=th_aff[1],
            h2_commit=th_aff[2],
            z1_commit=z_aff[0],
            z2_commit=z_aff[1],
            q_lo_commit=q_aff[0],
            q_mid_commit=q_aff[1],
            q_hi_commit=q_aff[2],
            aw_opening=aw_aff,
            saw_opening=saw_aff,
            evaluations=evals,
        )

    # ------------------------------------------------------------------

    def _linearization_terms(
        self, ev, alpha, beta, gamma, delta, epsilon, xi, zh_eval, l1_eval,
        pk_padded, abc_polys, z_polys, th_polys, q_polys,
    ):
        """Host-side linearization scalars (``linearization_poly.rs:77-111``
        + widget ``compute_linearization`` methods)."""
        p = self.p

        scalars = [ev.a * ev.b % p, ev.a, ev.b, ev.c, 1]
        polys = [
            pk_padded["q_m"],
            pk_padded["q_l"],
            pk_padded["q_r"],
            pk_padded["q_o"],
            pk_padded["q_c"],
        ]

        beta_xi = beta * xi % p
        z1_scalar = (
            alpha
            * ((beta_xi + ev.a + gamma) % p)
            * ((beta_xi * K1 + ev.b + gamma) % p)
            * ((beta_xi * K2 + ev.c + gamma) % p)
            + l1_eval * alpha * alpha
        ) % p
        scalars.append(z1_scalar)
        polys.append(z_polys[0])

        sigma3_scalar = (
            -alpha
            * beta
            * ev.z1_next
            * ((beta * ev.sigma1 + ev.a + gamma) % p)
            * ((beta * ev.sigma2 + ev.b + gamma) % p)
        ) % p
        scalars.append(sigma3_scalar)
        polys.append(pk_padded["sigma3"])

        alpha_cu = pow(alpha, 3, p)
        alpha_qu = pow(alpha, 4, p)
        one_plus_delta = (1 + delta) % p
        eps_1pd = epsilon * one_plus_delta % p
        z2_scalar = (
            alpha_cu
            * one_plus_delta
            * ((epsilon + ev.q_lookup * ev.c) % p)
            * ((eps_1pd + ev.t + delta * ev.t_next) % p)
            + alpha_qu * l1_eval
        ) % p
        scalars.append(z2_scalar)
        polys.append(z_polys[1])

        h1_scalar = (
            -alpha_cu * ev.z2_next * ((eps_1pd + ev.h2 + delta * ev.h1_next) % p)
        ) % p
        scalars.append(h1_scalar)
        polys.append(th_polys[1])

        scalars.append(alpha_qu * alpha % p * ev.t % p)
        polys.append(pk_padded["q_table"])

        xi_n2 = (zh_eval + 1) * xi * xi % p
        scalars.append((-zh_eval) % p)
        polys.append(q_polys[0])
        scalars.append((-zh_eval) * xi_n2 % p)
        polys.append(q_polys[1])
        scalars.append((-zh_eval) * xi_n2 % p * xi_n2 % p)
        polys.append(q_polys[2])

        return scalars, polys


class Prover(RoundSchedule):
    """Proves for one compiled circuit (fixed n) on the keys' device."""

    row_ops = LocalRows

    def __init__(self, ck, pk: ProverKey, epk: ExtendedProverKey, vk: VerifierKey,
                 lookup_table: LookupTable):
        from ..commitment import scheme as scheme_mod

        if epk is None:
            from .setup import extend_prover_key_from_pk

            epk = extend_prover_key_from_pk(ck, pk)
        self.ck = ck
        self.pk = pk
        self.epk = epk
        self.vk = vk
        self.table = lookup_table
        self.ctx = ck.ctx
        self.device = ck.device
        self.n = pk.n
        self.row_block = (0, self.n)
        self.domain = make_domain(self.ctx.curve.fr, self.n)
        self.spec = self.domain.spec
        self.p = self.spec.modulus
        self.scheme = scheme_mod.for_key(ck)
        self.committer = self.scheme.committer(ck)
        self.plan = self.domain.plan(self.device)
        self.q4 = self.domain.quarter_plan(self.device)
        self.pk_padded = {name: _pad4(pk.polys[name]) for name in PK_NAMES}
        self.t_ints = self.table.into_multiset(self.n)
        self.t_dev = self.rows(self.t_ints)

    # ------------------------------------------------------------------
    # device rounds
    # ------------------------------------------------------------------

    def commit_batch(self, evals: torch.Tensor, blinders: torch.Tensor) -> torch.Tensor:
        """iNTT a (B, n, L) batch, pad to n+4 and add the blinding terms
        b(X) * (X^n - 1) (blinders (B, 4, L))."""
        n, spec = self.n, self.spec
        padded = _pad4(ntt.ifft(spec, self.plan, evals))
        padded[:, n : n + 4] = blinders
        padded[:, :4] = fd.sub(spec, padded[:, :4], blinders)
        return padded

    def commit_many(self, polys: torch.Tensor) -> list:
        return self.committer.commit_many(polys)

    def z_round(self, wires, f, t, h1, h2, scalars, blinders) -> torch.Tensor:
        """Grand products z1 (permutation) and z2 (lookup), committed form."""
        epk = self.epk
        z_evals = grand_products(self.spec, self.row_ops, wires, f, t, h1, h2,
                                 epk.roots, epk.sigma_evals, scalars)
        return self.commit_batch(z_evals, blinders)

    def quotient_round(self, polys8, pi_evals, sc, weights, qblinders) -> torch.Tensor:
        """polys8: (8, n+4, L) [a,b,c,z1,z2,t,h1,h2] -> (3, n+4, L) q_lo/mid/hi.

        Runs on the interleaved 4n coset — every array is (..., 4, n, L).
        """
        spec, epk = self.spec, self.epk
        pi_poly = ntt.ifft(spec, self.plan, pi_evals)  # (n, L)
        nine = torch.cat([polys8, _pad4(pi_poly)[None]])  # (9, n+4, L)
        cs = ntt.coset4_fft(spec, self.plan, self.q4, nine)  # (9, 4, n, L)
        del nine
        q_evals = quotient_evals(spec, self.row_ops, cs, epk.coset, epk.x_coset, epk.l1_coset,
                                 epk.zh_coset_inv, sc, weights)
        del cs
        qrows = ntt.coset4_ifft(spec, self.plan, self.q4, q_evals)  # (4, n, L)
        q0, q1, q2, q3 = qrows.unbind(0)

        # split q into q_lo/q_mid/q_hi of n+2 coeffs each + boundary
        # blinders (``prove.rs:287-300``); row t holds q[tn:(t+1)n]
        b0, b1 = qblinders[0], qblinders[1]
        zrow = torch.zeros_like(b0)[None]
        q_lo = torch.cat([q0, q1[:2], b0[None], zrow])  # (n+4, L)
        q_mid = torch.cat([q1[2:], q2[:4], b1[None], zrow])
        q_mid[0] = fd.sub(spec, q_mid[0], b0)
        q_hi = torch.cat([q2[4:], q3[:8]])
        q_hi[0] = fd.sub(spec, q_hi[0], b1)
        return torch.stack([q_lo, q_mid, q_hi])  # (3, n+4, L)

    def evaluate(self, polys_xi, polys_wxi, xi: int, wxi: int):
        spec, n = self.spec, self.n
        xi_powers = fd.powers(spec, self.vec([xi])[0], n + 4)
        wxi_powers = fd.powers(spec, self.vec([wxi])[0], n + 4)
        return _eval_many(spec, polys_xi, xi_powers), _eval_many(spec, polys_wxi, wxi_powers)

    def linearize(self, polys13: torch.Tensor, scalars13: torch.Tensor) -> torch.Tensor:
        spec = self.spec
        terms = fd.mul(spec, polys13, scalars13[:, None, :])
        return tree_reduce(lambda a, b: fd.add(spec, a, b), terms, 0)

    def open_batch(self, polys: torch.Tensor, point: int, eta: int) -> torch.Tensor:
        """eta-fold the polys and divide by (X - point): the KZG witness."""
        from ..commitment import kzg

        spec, p = self.spec, self.p
        m = polys.shape[1]
        eta_powers = self.vec([pow(eta, i, p) for i in range(polys.shape[0])])
        pt_powers = fd.powers(spec, self.vec([point])[0], m)
        pt_inv = pow(point, -1, p)
        # [pt^-1, pt^-2, ..., pt^-m]
        pt_inv_powers = fd.mul(spec, fd.powers(spec, self.vec([pt_inv])[0], m), self.vec([pt_inv])[0])
        terms = fd.mul(spec, polys, eta_powers[:, None, :])
        folded = tree_reduce(lambda a, b: fd.add(spec, a, b), terms, 0)
        return kzg.divide_by_linear(spec, folded, pt_powers, pt_inv_powers)

    def openings(self, aw_polys, xi: int, saw_polys, wxi: int, eta: int):
        """The two openings of the key's scheme (KZG witnesses or IPA proofs)."""
        return (self.scheme.open_batch(self, aw_polys, xi, eta, b"aw"),
                self.scheme.open_batch(self, saw_polys, wxi, eta, b"saw"))


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _eval_many(spec, polys, powers):
    """Σ_j c_j x^j for each poly: elementwise mul + log-depth add-reduce."""
    return tree_reduce(lambda a, b: fd.add(spec, a, b), fd.mul(spec, polys, powers), 1)
