"""Circuit preprocessing: setup-mode CS -> (ProverKey, ExtendedProverKey,
VerifierKey).

Rebuild of ``plonk-core/src/proof_system/setup.rs:42-166``, as in
``zkt_plonk_tpu/proof_system/setup.py``: selector/sigma/table evaluation
columns are batch-iNTT'd into coefficient form, batch-committed, and
extended into the interleaved 4n coset tables.  Tables live on the
committer key's device; circuits with n <= 512 take host-int NTTs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..commitment import scheme as scheme_mod
from ..cs.composer import SetupComposer
from ..cs.lookup import LookupTable
from ..fields.device import upload
from ..fields.limbs import array_to_ints
from ..ops import ntt, ntt_host
from ..utils.domain import Domain, make_domain
from .keys import POLY_ORDER, ExtendedProverKey, ProverKey, VerifierKey

MIN_CIRCUIT_SIZE = 8  # quotient split needs 3n+6 <= 4n


def setup(
    ck,
    composer: SetupComposer,
    lookup_table: LookupTable,
    circuit_bound: int,
    extend: bool = True,
) -> Tuple[ProverKey, Optional[ExtendedProverKey], VerifierKey]:
    ctx = ck.ctx
    dev = ck.device
    p = ctx.curve.fr.modulus
    n = max(circuit_bound, MIN_CIRCUIT_SIZE)
    domain = make_domain(ctx.curve.fr, n)
    spec = domain.spec

    composer.pad_to(n)

    # sigma permutation walk (host) — ``permutation/mod.rs:103-177``
    roots = domain.elements()
    sigma_evals = composer.perm.compute_all_sigma_evals(n, roots, p)

    q_table = lookup_table.masks(n)

    eval_columns = [
        composer.q_m,
        composer.q_l,
        composer.q_r,
        composer.q_o,
        composer.q_c,
        sigma_evals[0],
        sigma_evals[1],
        sigma_evals[2],
        composer.q_lookup,
        q_table,
    ]
    if n <= ntt_host.HOST_NTT_MAX:
        polys_arr = upload(
            spec.n_limbs,
            [ntt_host.ifft_ints(col, domain.group_gen, p) for col in eval_columns],
            dev,
        )
    else:
        evals_arr = upload(spec.n_limbs, eval_columns, dev)  # (10, n, L)
        polys_arr = ntt.ifft(spec, domain.plan(dev), evals_arr)
        del evals_arr

    # batch-commit the 10 polynomials (``setup.rs:104-121``) at n+4
    # coefficients, the padded shape the prover commits
    padded = torch.nn.functional.pad(polys_arr, (0, 0, 0, 4))
    committer = scheme_mod.for_key(ck).committer(ck)
    commit_points = committer.commit_many(padded)
    del padded
    commits = {name: commit_points[i] for i, name in enumerate(POLY_ORDER)}

    pk = ProverKey(n=n, polys={name: polys_arr[i] for i, name in enumerate(POLY_ORDER)})
    vk = VerifierKey(
        n=n,
        pi_pos=list(composer.pp),
        commitments=commits,
        domain_gen=domain.group_gen,
    )

    epk = (
        extend_prover_key(ctx, domain, pk, sigma_evals, composer.q_lookup, dev)
        if extend
        else None
    )
    return pk, epk, vk


def extend_prover_key_from_pk(ck, pk: ProverKey) -> ExtendedProverKey:
    """Rebuild the EPK from PK polynomials by FFT — no circuit re-synthesis
    (the reference's on-demand extension, ``prove.rs:88-102``)."""
    ctx = ck.ctx
    dev = ck.device
    p = ctx.curve.fr.modulus
    n = pk.n
    domain = make_domain(ctx.curve.fr, n)
    spec = domain.spec
    names = ["sigma1", "sigma2", "sigma3", "q_lookup"]
    if n <= ntt_host.HOST_NTT_MAX:
        evals = [
            ntt_host.fft_ints(array_to_ints(pk.polys[nm].cpu().numpy()), domain.group_gen, p)
            for nm in names
        ]
    else:
        arr = ntt.fft(spec, domain.plan(dev), pk.stacked(names)).cpu().numpy()
        evals = [array_to_ints(arr[i]) for i in range(4)]
    return extend_prover_key(ctx, domain, pk, evals[:3], evals[3], dev)


def extend_prover_key(
    ctx, domain: Domain, pk: ProverKey, sigma_evals, q_lookup_evals, device
) -> ExtendedProverKey:
    """Interleaved 4n-coset tables + vanishing/lagrange precomputation
    (``keys/mod.rs:78-146``).  Entry [j][k] of a coset table is the value at
    g*w4n^j*w_n^k (global index 4k+j); zh on the coset depends only on j,
    so its inverse is 4 scalars."""
    n = domain.size
    p = domain.modulus
    spec = domain.spec
    domain4 = make_domain(ctx.curve.fr, 4 * n)

    stacked = pk.stacked(POLY_ORDER)  # (10, n, L)

    g_n = pow(domain.coset_gen, n, p)
    i4 = pow(domain4.group_gen, n, p)  # primitive 4th root of unity
    zh_vals = [(g_n * pow(i4, j, p) - 1) % p for j in range(4)]
    zh_inv_vals = [pow(v, -1, p) for v in zh_vals]

    roots_host = domain.elements()
    gj = [domain.coset_gen * pow(domain4.group_gen, j, p) % p for j in range(4)]
    x_coset_host = [[gjv * r % p for r in roots_host] for gjv in gj]

    # L1 on the coset: zh(x) / (n (x - 1))
    l1_denoms = [n * (x - 1) % p for row in x_coset_host for x in row]
    from ..fields.host import batch_inverse_ints

    l1_inv = batch_inverse_ints(l1_denoms, p)
    l1_vals = [zh_vals[i // n] * l1_inv[i] % p for i in range(4 * n)]

    if n <= ntt_host.HOST_NTT_MAX:
        coeff_ints = [array_to_ints(stacked[i].cpu().numpy()) for i in range(10)]
        evals = [ntt_host.coset_fft_ints(ci, gj_, domain.group_gen, p)
                 for ci in coeff_ints for gj_ in gj]
        coset_tables = upload(spec.n_limbs, evals, device).reshape(10, 4, n, spec.n_limbs)
    else:
        coset_tables = ntt.coset4_fft(
            spec, domain.plan(device), domain.quarter_plan(device), stacked
        )
    del stacked

    return ExtendedProverKey(
        n=n,
        coset={name: coset_tables[i] for i, name in enumerate(POLY_ORDER)},
        x_coset=upload(spec.n_limbs, x_coset_host, device),  # (4, n, L)
        zh_coset_inv=upload(spec.n_limbs, [zh_inv_vals], device)[0],  # (4, L)
        l1_coset=upload(spec.n_limbs, [l1_vals], device).reshape(4, n, spec.n_limbs),
        sigma_evals=upload(spec.n_limbs, sigma_evals, device),
        roots=upload(spec.n_limbs, [roots_host], device)[0],
        q_lookup_evals_host=list(q_lookup_evals),
    )
