"""Checkpoint (de)serialization for keys, SRS, trees and notes.

Role of ``bin/src/parser.rs`` + ark ``CanonicalSerialize`` in the
reference, in the file formats of ``zkt_plonk_tpu/utils/serialize.py``, so
that files move between the two packages in both directions: limb tables
are ``.npz`` arrays of ``uint16`` (16-bit limbs; ``q_lookup_evals`` as
``uint8``), host metadata is JSON.  Loaders put the limb tables on
``device`` as ``torch.int32`` (default ``"cuda"``; CUDA asked for but
absent raises); savers copy them to the host first.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .. import _cuda
from ..commitment import kzg
from ..convert import _tensor
from ..curves import make_context
from ..proof_system.keys import POLY_ORDER, ExtendedProverKey, ProverKey, VerifierKey
from ..proof_system.proof import Proof, ProofEvaluations


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _u16(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.uint16)


def save_committer_key(path: str, ck: kzg.CommitterKey):
    # uncompressed: point data is incompressible and compression costs
    # minutes at SRS scale
    np.savez(path, powers=_u16(ck.powers), curve=ck.ctx.name)


def load_committer_key(path: str, device="cuda") -> kzg.CommitterKey:
    from ..ops import ec

    dev = _cuda.require_cuda(device)
    data = np.load(_npz(path), allow_pickle=True)
    ctx = make_context(str(data["curve"]))
    return kzg.CommitterKey(
        ctx=ctx,
        powers=_tensor(data["powers"], dev),
        b3=ec.b3_const(ctx.fq_spec, ctx.curve.b, device=dev),
    )


def save_kzg_vk(path: str, cvk: kzg.VerifierKeyKZG):
    with open(path, "w") as f:
        json.dump(
            {
                "curve": cvk.ctx.name,
                "g1": [str(int(c)) for c in cvk.g1],
                "g2": [str(cvk.g2[0].a), str(cvk.g2[0].b), str(cvk.g2[1].a), str(cvk.g2[1].b)],
                "tau_g2": [
                    str(cvk.tau_g2[0].a),
                    str(cvk.tau_g2[0].b),
                    str(cvk.tau_g2[1].a),
                    str(cvk.tau_g2[1].b),
                ],
            },
            f,
        )


def load_kzg_vk(path: str) -> kzg.VerifierKeyKZG:
    from ..curves.tower import Fq2

    with open(path) as f:
        d = json.load(f)
    ctx = make_context(d["curve"])
    g2 = d["g2"]
    tg2 = d["tau_g2"]
    return kzg.VerifierKeyKZG(
        ctx=ctx,
        g1=(ctx.Fq(int(d["g1"][0])), ctx.Fq(int(d["g1"][1]))),
        g2=(
            Fq2(ctx.tower, int(g2[0]), int(g2[1])),
            Fq2(ctx.tower, int(g2[2]), int(g2[3])),
        ),
        tau_g2=(
            Fq2(ctx.tower, int(tg2[0]), int(tg2[1])),
            Fq2(ctx.tower, int(tg2[2]), int(tg2[3])),
        ),
    )


def save_prover_key(path: str, pk: ProverKey):
    np.savez(path, n=pk.n, **{name: _u16(pk.polys[name]) for name in POLY_ORDER})


def load_prover_key(path: str, device="cuda") -> ProverKey:
    dev = _cuda.require_cuda(device)
    data = np.load(_npz(path))
    return ProverKey(
        n=int(data["n"]),
        polys={name: _tensor(data[name], dev) for name in POLY_ORDER},
    )


def save_extended_prover_key(path: str, epk: ExtendedProverKey) -> None:
    """EPK checkpoint (the reference serializes the EPK too:
    ``main.rs:108-109``, ``parser.rs:5-23``)."""
    arrays = {f"coset_{k}": _u16(v) for k, v in epk.coset.items()}
    # uncompressed: limb data is uniform-random-looking
    np.savez(
        path,
        n=epk.n,
        x_coset=_u16(epk.x_coset),
        zh_coset_inv=_u16(epk.zh_coset_inv),
        l1_coset=_u16(epk.l1_coset),
        sigma_evals=_u16(epk.sigma_evals),
        roots=_u16(epk.roots),
        q_lookup_evals=np.asarray(epk.q_lookup_evals_host, dtype=np.uint8),
        **arrays,
    )


def load_extended_prover_key(path: str, device="cuda") -> ExtendedProverKey:
    dev = _cuda.require_cuda(device)
    data = np.load(_npz(path))
    t = lambda k: _tensor(data[k], dev)
    coset = {k[len("coset_"):]: t(k) for k in data.files if k.startswith("coset_")}
    return ExtendedProverKey(
        n=int(data["n"]),
        coset=coset,
        x_coset=t("x_coset"),
        zh_coset_inv=t("zh_coset_inv"),
        l1_coset=t("l1_coset"),
        sigma_evals=t("sigma_evals"),
        roots=t("roots"),
        q_lookup_evals_host=[int(v) for v in data["q_lookup_evals"]],
    )


def save_verifier_key(path: str, vk: VerifierKey):
    with open(path, "w") as f:
        json.dump(
            {
                "n": vk.n,
                "pi_pos": vk.pi_pos,
                "domain_gen": str(vk.domain_gen),
                "commitments": {
                    k: None if v is None else [str(v[0]), str(v[1])]
                    for k, v in vk.commitments.items()
                },
            },
            f,
        )


def load_verifier_key(path: str) -> VerifierKey:
    with open(path) as f:
        d = json.load(f)
    return VerifierKey(
        n=d["n"],
        pi_pos=d["pi_pos"],
        domain_gen=int(d["domain_gen"]),
        commitments={
            k: None if v is None else (int(v[0]), int(v[1]))
            for k, v in d["commitments"].items()
        },
    )


def save_json(path: str, obj: dict):
    with open(path, "w") as f:
        json.dump(obj, f)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


PROOF_POINTS = (
    "a_commit", "b_commit", "c_commit", "t_commit", "h1_commit", "h2_commit",
    "z1_commit", "z2_commit", "q_lo_commit", "q_mid_commit", "q_hi_commit",
    "aw_opening", "saw_opening",
)


def proof_to_dict(proof: Proof) -> dict:
    def pt(v):
        return None if v is None else [str(v[0]), str(v[1])]

    ev = proof.evaluations
    return {
        "commitments": {k: pt(getattr(proof, k)) for k in PROOF_POINTS},
        "evaluations": {k: str(getattr(ev, k)) for k in ev.__dataclass_fields__},
    }


def proof_from_dict(d: dict) -> Proof:
    def pt(v):
        return None if v is None else (int(v[0]), int(v[1]))

    c = d["commitments"]
    ev = {k: int(v) for k, v in d["evaluations"].items()}
    return Proof(**{k: pt(c[k]) for k in c}, evaluations=ProofEvaluations(**ev))
