"""The port's IPA commitment (``zkt_plonk_tpu_torch.commitment.ipa``) and
the PLONK pipeline over it, on the CPU, against the JAX package.

* the generators (the first 8 and ``u``) on BN254, BLS12-381 and
  BLS12-377 equal the JAX package's;
* on the fixture of ``tests/test_ipa.py`` (BN254, max_degree 31): commit
  (the host MSM, and the port's MSM on the key's device: here the plain
  versions of K4a and K4), ``open_poly``, ``check``, ``open_batch`` and
  ``check_batch`` equal the JAX package's, and the rejection cases of
  that file (wrong value, wrong point, tampered final scalar, wrong batch
  value) are rejected by both;
* ``convert.ipa_keys`` carries a JAX key across: same generators, the
  same device table as the port's own setup;
* the BLS12-381 + IPA + Merlin (48-byte coordinates) proof of the
  SmallCircuitDef of ``tests/test_e2e.py`` (seed 14, max_degree 32) equals
  the JAX package's field for field (commitments, evaluations, the L/R
  points and ``a_final`` of both openings), verifies, and fails its tamper
  probes.
"""

import copy
import dataclasses
import os
import random

import numpy as np
import pytest
import torch

from zkt_plonk_tpu.commitment import ipa as jipa
from zkt_plonk_tpu.cs import LookupTable as JLookupTable
from zkt_plonk_tpu.cs import lt as jlt
from zkt_plonk_tpu.curves import make_context as jax_make_context
from zkt_plonk_tpu.plonk import ZKTPlonk as JZKTPlonk
from zkt_plonk_tpu.transcript.merlin import MerlinTranscript as JMerlinTranscript
from zkt_plonk_tpu_torch import convert
from zkt_plonk_tpu_torch.commitment import ipa, scheme
from zkt_plonk_tpu_torch.cs import LookupTable, lt
from zkt_plonk_tpu_torch.curves import make_context
from zkt_plonk_tpu_torch.fields.limbs import ints_to_array
from zkt_plonk_tpu_torch.plonk import ZKTPlonk
from zkt_plonk_tpu_torch.proof_system.proof import VerificationError
from zkt_plonk_tpu_torch.transcript.merlin import MerlinTranscript


@pytest.fixture(scope="module", autouse=True)
def _share_cores_with_xdist_workers():
    """The plain versions run many small torch ops; under pytest-xdist every
    worker's intra-op threads would contend for all cores, so each worker
    takes its share of them while this module runs."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


def _ints(pt):
    return None if pt is None else (int(pt[0]), int(pt[1]))


def _carry(jck):
    """The port's key from a JAX key, through ``convert.ipa_keys``."""
    ck, cvk = convert.ipa_keys(
        jck.ctx.name, [_ints(g) for g in jck.gens], _ints(jck.u), jck.max_degree, device="cpu"
    )
    assert ck is cvk
    return ck


@pytest.mark.parametrize("curve", ["bn254", "bls12_381", "bls12_377"])
def test_generators_match_jax(curve):
    ctx, jctx = make_context(curve), jax_make_context(curve)
    for tag in [b"G%d" % i for i in range(8)] + [b"U"]:
        assert _ints(ipa.hash_to_point(ctx, tag)) == _ints(jipa.hash_to_point(jctx, tag))


@pytest.fixture(scope="module")
def keys():
    jck, _ = jipa.setup("bn254", max_degree=31)
    ck, cvk = ipa.setup("bn254", max_degree=31, device="cpu")
    assert ck is cvk and ck.max_degree == jck.max_degree == 31
    return jck, ck


def _rand_poly(rng, r, deg):
    return [rng.randrange(r) for _ in range(deg + 1)]


def _proof_fields(proof):
    return ([_ints(p) for p in proof.l_points], [_ints(p) for p in proof.r_points],
            proof.a_final)


def test_setup_and_carried_key_match(keys):
    jck, ck = keys
    assert [_ints(g) for g in ck.gens] == [_ints(g) for g in jck.gens]
    assert _ints(ck.u) == _ints(jck.u)
    carried = _carry(jck)
    assert torch.equal(carried.gens_dev, ck.gens_dev)
    assert carried.b3.value == ck.b3.value == 9
    assert carried.device == torch.device("cpu") and tuple(ck.gens_dev.shape) == (32, 3, 16)
    with pytest.raises(ValueError, match="max_degree"):
        convert.ipa_keys("bn254", [_ints(g) for g in jck.gens], _ints(jck.u), 30, device="cpu")


def test_default_device_is_the_card():
    """``ipa.setup`` and ``convert.ipa_keys`` default to CUDA, absent here."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ipa.setup("bn254", max_degree=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.ipa_keys("bn254", [None], None, 0)


def test_commit_open_check_match_jax(keys):
    jck, ck = keys
    rng = random.Random(7)
    r = ck.ctx.curve.fr.modulus
    poly = _rand_poly(rng, r, 17)
    c = ipa.commit(ck, poly)
    assert _ints(c) == _ints(jipa.commit(jck, poly))
    assert _ints(ipa.commit(ck, poly, device=True)) == _ints(c)  # the port's MSM
    z = rng.randrange(r)
    v = ipa._eval_poly(poly, z, r)
    proof = ipa.open_poly(ck, poly, z, v)
    jproof = jipa.open_poly(jck, poly, z, v)
    assert _proof_fields(proof) == _proof_fields(jproof)
    assert ipa.check(ck, c, z, v, proof)
    # the rejection cases of tests/test_ipa.py, in both packages
    bad = ipa.IPAProof(proof.l_points, proof.r_points, (proof.a_final + 1) % r)
    jbad = jipa.IPAProof(jproof.l_points, jproof.r_points, (jproof.a_final + 1) % r)
    jc = jipa.commit(jck, poly)
    for args, jargs in (((c, z, (v + 1) % r, proof), (jc, z, (v + 1) % r, jproof)),
                        ((c, (z + 1) % r, v, proof), (jc, (z + 1) % r, v, jproof)),
                        ((c, z, v, bad), (jc, z, v, jbad))):
        assert not ipa.check(ck, *args)
        assert not jipa.check(jck, *jargs)


def test_batch_open_check_match_jax(keys):
    jck, ck = keys
    rng = random.Random(10)
    r = ck.ctx.curve.fr.modulus
    polys = [_rand_poly(rng, r, d) for d in (5, 11, 17)]
    # the committer of the pipeline: one batched MSM, polys padded to one length
    rows = torch.from_numpy(np.stack(
        [ints_to_array(p + [0] * (18 - len(p)), 16) for p in polys]).astype(np.int32))
    commits = scheme.for_key(ck).committer(ck).commit_many(rows)
    assert commits == [_ints(jipa.commit(jck, p)) for p in polys]
    z = rng.randrange(r)
    eta = rng.randrange(r)
    proof, v = ipa.open_batch(ck, polys, z, eta)
    jproof, jv = jipa.open_batch(jck, polys, z, eta)
    assert v == jv and _proof_fields(proof) == _proof_fields(jproof)
    Fq = ck.ctx.Fq
    pts = [(Fq(x), Fq(y)) for x, y in commits]
    values = [ipa._eval_poly(p, z, r) for p in polys]
    assert ipa.check_batch(ck, pts, z, values, eta, proof)
    values[1] = (values[1] + 1) % r
    assert not ipa.check_batch(ck, pts, z, values, eta, proof)


class SmallCircuitDef:
    """``tests/test_e2e.py:SmallCircuitDef`` for either package."""

    def __init__(self, lt_fn):
        self.lt = lt_fn

    def synthesize(self, cs):
        a = cs.assign_variable(2)
        b = cs.assign_variable(3)
        c = cs.mul_gate(self.lt(a), self.lt(b))
        cs.set_variable_public(self.lt(c))
        cs.lookup_constrain(self.lt(a))


def _flatten(proof):
    """Every field of a proof as plain ints, tuples and lists."""
    out = {}
    for f in dataclasses.fields(proof):
        v = getattr(proof, f.name)
        if f.name == "evaluations":
            out[f.name] = dataclasses.astuple(v)
        elif f.name in ("aw_opening", "saw_opening"):
            out[f.name] = _proof_fields(v)
        else:
            out[f.name] = _ints(v)
    return out


def test_bls12_381_ipa_proof_matches_jax():
    """``tests/test_e2e.py:test_full_prove_verify_ipa[bls12_381-14]`` in both
    packages, the port's key carried across from the JAX one."""
    curve, seed = "bls12_381", 14
    merlin = lambda label: MerlinTranscript(label, coord_bytes=48)
    jinst = JZKTPlonk(curve=curve, table=JLookupTable([1, 2, 5], size=4),
                      transcript_factory=lambda label: JMerlinTranscript(label, coord_bytes=48))
    jck, jcvk = jipa.setup(curve, max_degree=32)
    jcompiled = jinst.compile(SmallCircuitDef(jlt), jck, jcvk)
    jproof = jinst.prove(jcompiled, SmallCircuitDef(jlt), random.Random(seed))

    inst = ZKTPlonk(curve=curve, table=LookupTable([1, 2, 5], size=4), device="cpu",
                    transcript_factory=merlin)
    ck = _carry(jck)
    compiled = inst.compile(SmallCircuitDef(lt), ck, ck)
    for name, pt in compiled.vk.commitments.items():
        assert pt == _ints(jcompiled.vk.commitments[name]), name
    proof = inst.prove(compiled, SmallCircuitDef(lt), random.Random(seed))
    assert _flatten(proof) == _flatten(jproof)

    inst.verify(compiled, proof, [6])
    with pytest.raises((VerificationError, AssertionError)):
        inst.verify(compiled, proof, [7])
    tampered = copy.deepcopy(proof)
    tampered.evaluations.a = (tampered.evaluations.a + 1) % inst.p
    with pytest.raises(VerificationError):
        inst.verify(compiled, tampered, [6])
