"""The port's whole pipeline on the CPU against the JAX package.

(a) the golden proof of ``tests/test_e2e.py`` (TinyCircuit, SRS degree 256,
    tau=123456789, seed 9) from the port's own setup/compile/prove: 802
    bytes, the same sha256;
(b) for ``TestCircuitDef`` (n = 128) every PK/EPK table and VK commitment of
    the port's ``compile`` equals the JAX package's, limb for limb;
(c) the JAX package's compiled TinyCircuit, carried across by
    ``zkt_plonk_tpu_torch.convert``, proves to the same golden digest;
(d) the proof verifies, and the tamper probes of ``tests/test_e2e.py``
    (wrong public input, tampered evaluation) raise;
(e) with the Merlin transcript of each package's ``config`` (the CLI's
    default), the same TinyCircuit, SRS and seed give byte-equal proofs in
    both packages, and the port's verifies and fails its tamper probes;
(f) with the span recorder (``utils/profiling``) on, the proof records
    its spans and counts, and proves the same bytes; off, it records
    nothing;
and the port imports with neither ``jax`` nor ``zkt_plonk_tpu`` loaded,
as a whole and module by module for the CLI's modules, the IPA, the
scheme dispatch, the withdraw instance and the parallel layer.
"""

import copy
import hashlib
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from zkt_plonk_tpu import config as jconfig
from zkt_plonk_tpu.commitment import kzg as jkzg
from zkt_plonk_tpu.cs import LookupTable as JLookupTable
from zkt_plonk_tpu.cs import lt as jlt
from zkt_plonk_tpu.curves import make_context as jax_make_context
from zkt_plonk_tpu.plonk import ZKTPlonk as JZKTPlonk
from zkt_plonk_tpu.utils import arkserde as jarkserde
from zkt_plonk_tpu_torch import config, convert
from zkt_plonk_tpu_torch.commitment import kzg
from zkt_plonk_tpu_torch.cs import LookupTable, lt
from zkt_plonk_tpu_torch.plonk import ZKTPlonk
from zkt_plonk_tpu_torch.proof_system.keys import POLY_ORDER
from zkt_plonk_tpu_torch.proof_system.proof import VerificationError
from zkt_plonk_tpu_torch.utils import arkserde


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


GOLDEN = "504e1dbfaa28af3d1e9da112bbb4329374e06669416c39ec1fc8015df71d3cba"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TinyCircuit:
    """The golden circuit of ``tests/test_e2e.py``, for either package."""

    def __init__(self, lt_fn):
        self.lt = lt_fn

    def synthesize(self, cs):
        a = cs.assign_variable(2)
        b = cs.assign_variable(3)
        c = cs.mul_gate(self.lt(a), self.lt(b))
        d = cs.add_gate(self.lt(c), self.lt(a))
        cs.set_variable_public(self.lt(d))
        cs.lookup_constrain(self.lt(a))


class TestCircuitDef:
    """``tests/test_e2e.py:TestCircuitDef`` (a + b = c, d = a*c public,
    a boolean select, c in the lookup table), for either package."""

    __test__ = False

    def __init__(self, lt_fn):
        self.lt = lt_fn

    def synthesize(self, cs):
        a = cs.assign_variable(2)
        b = cs.assign_variable(3)
        c = cs.add_gate(self.lt(a), self.lt(b))
        sels = cs.sels().with_mul(-1)
        cs.arith_constrain(a, c, -1, sels, pi=10)
        e = cs.assign_variable(1)
        eb = cs.boolean_gate(e)
        f = cs.conditional_select(eb, self.lt(a), self.lt(b))
        cs.set_variable_public(self.lt(f))
        cs.lookup_constrain(self.lt(c))


def _digest(inst, proof):
    blob = arkserde.proof_to_bytes(proof, inst.ctx.curve.fq.modulus, inst.ctx.curve.fr.modulus)
    return len(blob), hashlib.sha256(blob).hexdigest()


@pytest.fixture(scope="module")
def golden():
    inst = ZKTPlonk(curve="bn254", table=LookupTable([1, 2, 5], size=63), device="cpu")
    ck, cvk = kzg.setup(inst.ctx, max_degree=4 * 64, tau=123456789, device="cpu")
    compiled = inst.compile(TinyCircuit(lt), ck, cvk)
    proof = inst.prove(compiled, TinyCircuit(lt), rng=random.Random(9))
    return inst, compiled, proof


def test_golden_proof_bytes(golden):
    inst, _, proof = golden
    assert _digest(inst, proof) == (802, GOLDEN)


def test_verify_and_tamper_probes(golden):
    inst, compiled, proof = golden
    inst.verify(compiled, proof, [8])
    with pytest.raises((VerificationError, AssertionError)):
        inst.verify(compiled, proof, [9])
    tampered = copy.deepcopy(proof)
    tampered.evaluations.a = (tampered.evaluations.a + 1) % inst.p
    with pytest.raises(VerificationError):
        inst.verify(compiled, tampered, [8])


ROUNDS = ("witness", "round1+2", "round3", "round4", "round5", "linearization", "openings")


def test_timing_sections_change_nothing(golden):
    """With the span recorder on, one proof records its statement and its
    prover's seven round spans and the spans inside them, with their
    parents and one request id, counts what it stages, waits for and asks
    of K4a and K6, and still proves the golden bytes."""
    from zkt_plonk_tpu_torch import _cuda
    from zkt_plonk_tpu_torch.ops import msm
    from zkt_plonk_tpu_torch.utils import profiling

    inst, compiled, _ = golden
    c0, adds0, merges0 = profiling.snapshot(), _cuda.work["ec_bucket_adds"], _cuda.work["ec_merge_adds"]
    profiling.drain()
    profiling.enable()
    try:
        proof = inst.prove(compiled, TinyCircuit(lt), rng=random.Random(9))
    finally:
        profiling.enable(False)
    spans = profiling.drain()
    assert _digest(inst, proof) == (802, GOLDEN)

    by_index = {s.index: s for s in spans}

    def path(s):
        return s.name if s.parent == -1 else f"{path(by_index[s.parent])}/{s.name}"

    paths = [path(s) for s in spans]
    assert {s.request for s in spans} == {spans[0].request}
    assert {s.thread for s in spans} == {spans[0].thread}
    assert [p for p in paths if "/" not in p] == ["statement", "prove"]
    assert sorted(p for p in paths if p.startswith("statement/")) == [
        "statement/seed_transcript", "statement/synthesize"]
    children = [p.split("/")[1] for p in paths if p.count("/") == 1 and p.startswith("prove/")]
    assert set(children) == set(ROUNDS) | {"stage", "lookup_sort", "linearization_terms"}
    for rnd in ROUNDS:
        assert children.count(rnd) == 1, rnd
    commits = [p for p in paths if p.endswith("/commit")]
    assert sorted(commits) == sorted(["prove/round1+2/commit", "prove/round3/commit",
                                      "prove/round4/commit"] + ["prove/openings/commit"] * 2)
    for c in set(commits):
        for inner in ("msm", "wait", "fold"):
            assert paths.count(f"{c}/{inner}") == commits.count(c), (c, inner)
    assert paths.count("prove/round5/wait") == 2
    for s in spans:  # every span lies inside its parent
        if s.parent != -1:
            parent = by_index[s.parent]
            assert parent.start <= s.start <= s.end <= parent.end

    counts = {k: v - c0[k] for k, v in profiling.snapshot().items()}
    assert counts["host_waits"] == sum(p.endswith("/wait") for p in paths) == 7
    # 4 gates on the 64 rows the 63-entry table needs
    assert (counts["circuit_gates"], counts["domain_rows"]) == (4, 64)
    assert counts["h2d_copies"] > paths.count("prove/stage") and counts["h2d_bytes"] > 0
    # B x W x n per batch: 6 + 2 + 3 + 1 + 1 polynomials of n + 4 = 68
    # coefficients, W = 64 windows of c = 4 bits
    fr_bits = inst.ctx.curve.fr.modulus.bit_length()
    c = msm.msm_window_size(68)
    W = msm.num_windows(fr_bits + 1, c)
    assert _cuda.work["ec_bucket_adds"] - adds0 == 13 * W * 68
    # and the group merge (G - 1) x B x W x (K - 1) per batch
    K = (1 << (c - 1)) + 1
    merge = sum((msm.group_count(68, c, B, W, 16) - 1) * B * W * (K - 1) for B in (6, 2, 3, 1, 1))
    assert _cuda.work["ec_merge_adds"] - merges0 == merge


def test_a_proof_with_the_recorder_off_records_nothing(golden):
    """Off, the recorder keeps no span; the counters count all the same."""
    from zkt_plonk_tpu_torch.utils import profiling

    inst, compiled, _ = golden
    assert not profiling.enabled()
    profiling.drain()
    waits0 = profiling.snapshot()["host_waits"]
    proof = inst.prove(compiled, TinyCircuit(lt), rng=random.Random(9))
    assert profiling.drain() == []
    assert profiling.snapshot()["host_waits"] - waits0 == 7
    assert _digest(inst, proof) == (802, GOLDEN)


def test_compile_matches_jax_keys():
    table = [1, 2, 5]
    jinst = JZKTPlonk(curve="bn254", table=JLookupTable(table, size=100))
    jck, jcvk = jkzg.setup(jax_make_context("bn254"), max_degree=512, tau=987654321)
    jc = jinst.compile(TestCircuitDef(jlt), jck, jcvk)

    inst = ZKTPlonk(curve="bn254", table=LookupTable(table, size=100), device="cpu")
    ck, cvk = kzg.setup(inst.ctx, max_degree=512, tau=987654321, device="cpu")
    c = inst.compile(TestCircuitDef(lt), ck, cvk)

    def eq(got, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int32))

    assert c.vk.n == jc.vk.n == 128
    eq(c.ck.powers, jc.ck.powers)
    for name in POLY_ORDER:
        eq(c.pk.polys[name], jc.pk.polys[name])
        eq(c.epk.coset[name], jc.epk.coset[name])
    for name in ("x_coset", "zh_coset_inv", "l1_coset", "sigma_evals", "roots"):
        eq(getattr(c.epk, name), getattr(jc.epk, name))
    assert c.epk.q_lookup_evals_host == list(jc.epk.q_lookup_evals_host)
    assert c.vk.commitments == jc.vk.commitments
    assert c.vk.pi_pos == jc.vk.pi_pos and c.vk.domain_gen == jc.vk.domain_gen
    assert cvk.tau_g2 == (
        type(cvk.tau_g2[0])(cvk.ctx.tower, jcvk.tau_g2[0].a, jcvk.tau_g2[0].b),
        type(cvk.tau_g2[1])(cvk.ctx.tower, jcvk.tau_g2[1].a, jcvk.tau_g2[1].b),
    )


def test_converted_jax_keys_prove_golden():
    jinst = JZKTPlonk(curve="bn254", table=JLookupTable([1, 2, 5], size=63))
    jck, jcvk = jkzg.setup(jinst.ctx, max_degree=4 * 64, tau=123456789)
    jc = jinst.compile(TinyCircuit(jlt), jck, jcvk)
    epk = {name: np.asarray(getattr(jc.epk, name)) for name in convert.EPK_TABLES}
    epk["coset"] = {k: np.asarray(v) for k, v in jc.epk.coset.items()}
    epk["q_lookup_evals_host"] = list(jc.epk.q_lookup_evals_host)
    compiled = convert.compiled_circuit(
        "bn254",
        srs_powers=np.asarray(jc.ck.powers),
        tau_g2=((jc.cvk.tau_g2[0].a, jc.cvk.tau_g2[0].b), (jc.cvk.tau_g2[1].a, jc.cvk.tau_g2[1].b)),
        pk_polys={k: np.asarray(v) for k, v in jc.pk.polys.items()},
        epk=epk,
        vk={"n": jc.vk.n, "pi_pos": jc.vk.pi_pos, "commitments": jc.vk.commitments,
            "domain_gen": jc.vk.domain_gen},
        device="cpu",
    )
    inst = ZKTPlonk(curve="bn254", table=LookupTable([1, 2, 5], size=63), device="cpu")
    proof = inst.prove(compiled, TinyCircuit(lt), rng=random.Random(9))
    assert _digest(inst, proof) == (802, GOLDEN)


def test_merlin_proof_bytes_match_jax():
    jinst = JZKTPlonk(curve="bn254", table=JLookupTable([1, 2, 5], size=63),
                      transcript_factory=jconfig.transcript_factory("merlin"))
    jck, jcvk = jkzg.setup(jinst.ctx, max_degree=4 * 64, tau=123456789)
    jc = jinst.compile(TinyCircuit(jlt), jck, jcvk)
    jproof = jinst.prove(jc, TinyCircuit(jlt), rng=random.Random(9))
    want = jarkserde.proof_to_bytes(jproof, jinst.ctx.curve.fq.modulus, jinst.ctx.curve.fr.modulus)

    inst = ZKTPlonk(curve="bn254", table=LookupTable([1, 2, 5], size=63),
                    transcript_factory=config.transcript_factory("merlin"), device="cpu")
    ck, cvk = kzg.setup(inst.ctx, max_degree=4 * 64, tau=123456789, device="cpu")
    compiled = inst.compile(TinyCircuit(lt), ck, cvk)
    proof = inst.prove(compiled, TinyCircuit(lt), rng=random.Random(9))
    got = arkserde.proof_to_bytes(proof, inst.ctx.curve.fq.modulus, inst.ctx.curve.fr.modulus)
    assert len(got) == 802 and got == want
    assert hashlib.sha256(got).hexdigest() != GOLDEN  # the transcript matters

    inst.verify(compiled, proof, [8])
    with pytest.raises((VerificationError, AssertionError)):
        inst.verify(compiled, proof, [9])
    tampered = copy.deepcopy(proof)
    tampered.evaluations.a = (tampered.evaluations.a + 1) % inst.p
    with pytest.raises(VerificationError):
        inst.verify(compiled, tampered, [8])
    # an Ethereum verifier refuses the Merlin proof
    eth = ZKTPlonk(curve="bn254", table=LookupTable([1, 2, 5], size=63), device="cpu")
    with pytest.raises((VerificationError, AssertionError)):
        eth.verify(compiled, proof, [8])


@pytest.mark.parametrize("module", [
    "cli", "config", "utils.serialize", "transcript.merlin", "hashing.poseidon.device",
    "commitment.ipa", "commitment.scheme", "circuits.withdraw_instance", "parallel",
])
def test_cli_modules_import_without_jax(module):
    code = (
        "import sys, importlib\n"
        f"importlib.import_module('zkt_plonk_tpu_torch.{module}')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'zkt_plonk_tpu' or m.startswith('zkt_plonk_tpu.')]\n"
        "assert not bad, bad\n"
        f"assert 'zkt_plonk_tpu_torch.{module}' in sys.modules\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_port_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib, zkt_plonk_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'zkt_plonk_tpu' or m.startswith('zkt_plonk_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith('zkt_plonk_tpu_torch')]))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
