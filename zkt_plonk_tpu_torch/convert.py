"""Carry a compiled circuit's state across from the JAX package.

The JAX package's ``CompiledCircuit`` holds the SRS powers, the prover key
polynomials, the extended prover key tables and the verifier key.  Handed
over as numpy arrays and plain ints (the caller does the ``np.asarray``),
``compiled_circuit`` turns them into this package's keys on ``device``, so
the port proves from the same state without recompiling: this system's
counterpart of loading model weights.  ``ipa_keys`` does the same for an
IPA key, whose generators cost ~17 ms each to derive on the BLS12 curves.
Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from . import _cuda
from .commitment import ipa, kzg
from .curves import make_context
from .curves.tower import Fq2
from .ops import ec
from .plonk import CompiledCircuit
from .proof_system.keys import POLY_ORDER, ExtendedProverKey, ProverKey, VerifierKey

EPK_TABLES = ("x_coset", "zh_coset_inv", "l1_coset", "sigma_evals", "roots")


def _tensor(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.kind not in "iu" or (arr.size and int(arr.max()) >= 1 << 16):
        raise ValueError("expected 16-bit limb arrays")
    return torch.from_numpy(np.ascontiguousarray(arr).astype(np.int32)).to(device)


def ipa_keys(curve: str, gens, u, max_degree: int, device="cuda"):
    """The port's IPA key pair (one self-dual key, as ``ipa.setup`` returns)
    from a JAX ``CommitterKeyIPA``'s generators and ``u``, handed over as
    (x, y) ints (None for the identity), with its ``max_degree``."""
    dev = _cuda.require_cuda(device)
    if max_degree != len(gens) - 1:
        raise ValueError(f"max_degree {max_degree} for {len(gens)} generators")
    ctx = make_context(curve)

    def point(pt):
        return None if pt is None else (ctx.Fq(int(pt[0])), ctx.Fq(int(pt[1])))

    ck = ipa.make_key(ctx, [point(g) for g in gens], point(u), device=dev)
    return ck, ck


def compiled_circuit(
    curve: str,
    srs_powers: np.ndarray,
    tau_g2: Tuple[Tuple[int, int], Tuple[int, int]],
    pk_polys: Mapping[str, np.ndarray],
    epk: Optional[Mapping[str, object]],
    vk: Mapping[str, object],
    device="cuda",
) -> CompiledCircuit:
    """Build this package's ``CompiledCircuit`` from carried-over arrays.

    srs_powers: (N, 3, L) projective SRS G1 powers (the trimmed ``ck.powers``);
    tau_g2: [tau]G2 as ((x.c0, x.c1), (y.c0, y.c1)) ints;
    pk_polys: name -> (n, L) coefficient limbs, for every name of POLY_ORDER;
    epk: None, or ``coset`` (name -> (4, n, L)), the arrays of EPK_TABLES and
         ``q_lookup_evals_host`` (n ints);
    vk: ``n``, ``pi_pos`` (ints), ``commitments`` (name -> (x, y) ints or
        None) and ``domain_gen``.
    """
    dev = _cuda.require_cuda(device)
    ctx = make_context(curve)
    b3 = ec.b3_const(ctx.fq_spec, ctx.curve.b, device=dev)
    ck = kzg.CommitterKey(ctx=ctx, powers=_tensor(srs_powers, dev), b3=b3)
    (x0, x1), (y0, y1) = tau_g2
    cvk = kzg.VerifierKeyKZG(
        ctx=ctx,
        g1=ctx.g1,
        g2=ctx.g2,
        tau_g2=(Fq2(ctx.tower, int(x0), int(x1)), Fq2(ctx.tower, int(y0), int(y1))),
    )
    n = int(vk["n"])
    pk = ProverKey(n=n, polys={name: _tensor(pk_polys[name], dev) for name in POLY_ORDER})
    ext = None
    if epk is not None:
        coset: Dict[str, torch.Tensor] = {
            name: _tensor(epk["coset"][name], dev) for name in POLY_ORDER
        }
        ext = ExtendedProverKey(
            n=n,
            coset=coset,
            **{name: _tensor(epk[name], dev) for name in EPK_TABLES},
            q_lookup_evals_host=[int(v) for v in epk["q_lookup_evals_host"]],
        )
    commitments: Dict[str, Optional[Tuple[int, int]]] = {
        name: None if pt is None else (int(pt[0]), int(pt[1]))
        for name, pt in vk["commitments"].items()
    }
    verifier_key = VerifierKey(
        n=n,
        pi_pos=[int(i) for i in vk["pi_pos"]],
        commitments=commitments,
        domain_gen=int(vk["domain_gen"]),
    )
    return CompiledCircuit(ck=ck, cvk=cvk, pk=pk, epk=ext, vk=verifier_key)
