"""The port on the BLS12 curves against the JAX package, on the CPU: the
plain versions of the kernels' BLS12 instances and the BLS12-381 + KZG
pipeline.

* K1's plain version on the BLS12 base fields (L = 24) and on BLS12-381's
  scalar field, against ``zkt_plonk_tpu.fields.device``;
* K4's plain version at L = 24 against the JAX package's composed
  ``ops/ec.add`` on both BLS12 base fields, with the edge cases of
  ``tests/test_ec_pallas.py`` (identity + P, P + identity, P + P,
  P + (-P)) and projective (Z != 1) inputs, and against host affine adds;
* K4a's plain version at L = 24 against ``zkt_plonk_tpu.ops.msm._accumulate``
  as bucket limbs, bit for bit (n = 68, c = 4, G = 8; 0, 1, r - 1 and a
  negative-zero digit among the scalars);
* the NTT's four transforms on BLS12-381's and BLS12-377's scalar fields
  (single-pass 2^6 and two-pass 2^9 plans) against ``zkt_plonk_tpu.ops.ntt``;
* K2's plain version (the sliding-window chain) on BLS12-381's scalar
  field against the JAX Pallas kernel in interpret mode and ``pow``;
* the BLS12-381 + KZG + Merlin (48-byte coordinates) proof of the
  SmallCircuitDef of ``tests/test_e2e.py`` (tau 24680, seed 12), byte for
  byte against the JAX package's, with its tamper probes.

Every comparison is exact equality of limbs, points or bytes.
"""

import copy
import hashlib
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkt_plonk_tpu.commitment import kzg as jkzg
from zkt_plonk_tpu.cs import LookupTable as JLookupTable
from zkt_plonk_tpu.cs import lt as jlt
from zkt_plonk_tpu.curves import make_context as jax_make_context
from zkt_plonk_tpu.fields import device as jfd
from zkt_plonk_tpu.fields import make_spec as jax_make_spec
from zkt_plonk_tpu.fields import pallas as jpallas
from zkt_plonk_tpu.ops import ec as jec
from zkt_plonk_tpu.ops import msm as jmsm
from zkt_plonk_tpu.ops import ntt as jntt
from zkt_plonk_tpu.plonk import ZKTPlonk as JZKTPlonk
from zkt_plonk_tpu.transcript.merlin import MerlinTranscript as JMerlinTranscript
from zkt_plonk_tpu.utils import arkserde as jarkserde
from zkt_plonk_tpu.utils.domain import make_domain as jax_make_domain
from zkt_plonk_tpu_torch.commitment import kzg
from zkt_plonk_tpu_torch.cs import LookupTable, lt
from zkt_plonk_tpu_torch.curves import curve_host as ch
from zkt_plonk_tpu_torch.curves import make_context
from zkt_plonk_tpu_torch.fields import cuda as tfc
from zkt_plonk_tpu_torch.fields import device as tfd
from zkt_plonk_tpu_torch.fields import make_spec
from zkt_plonk_tpu_torch.fields.limbs import array_to_ints, ints_to_array
from zkt_plonk_tpu_torch.fields.params import (
    BLS12_377_FQ, BLS12_377_FR, BLS12_381_FQ, BLS12_381_FR,
)
from zkt_plonk_tpu_torch.ops import ec, msm, ntt
from zkt_plonk_tpu_torch.plonk import ZKTPlonk
from zkt_plonk_tpu_torch.proof_system.proof import VerificationError
from zkt_plonk_tpu_torch.transcript.merlin import MerlinTranscript
from zkt_plonk_tpu_torch.utils import arkserde
from zkt_plonk_tpu_torch.utils.domain import make_domain


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


CURVES = ["bls12_381", "bls12_377"]


def _t(ints, L):
    return torch.from_numpy(ints_to_array(ints, L).astype(np.int32))


def _j(t):
    return jnp.asarray(t.numpy().astype(np.uint32))


@pytest.mark.parametrize("params", [BLS12_381_FQ, BLS12_377_FQ, BLS12_381_FR], ids=lambda f: f.name)
def test_binops_match_jax(params):
    """K1's plain version at L = 24 (the base fields) and on BLS12-381's
    scalar field, on 0, 1, p - 1, (p - 1)/2 and random pairs."""
    spec = make_spec(params)
    L = spec.n_limbs
    p = params.modulus
    rng = random.Random(24)
    fixtures = [0, 1, 2, p - 1, p - 2, (p - 1) // 2]
    a = [x for x in fixtures for _ in fixtures] + [rng.randrange(p) for _ in range(64)]
    b = [y for _ in fixtures for y in fixtures] + [rng.randrange(p) for _ in range(64)]
    jspec = jax_make_spec(params)
    ref = jax.jit(lambda x, y: (jfd.add(jspec, x, y), jfd.sub(jspec, x, y), jfd.mul(jspec, x, y)))
    A, B = _t(a, L), _t(b, L)
    want = ref(_j(A), _j(B))
    for op, w in zip(("add", "sub", "mul"), want):
        got = tfc.binop_plain(spec, op, A, B)
        np.testing.assert_array_equal(got.numpy(), np.asarray(w).astype(np.int32))


@pytest.fixture(scope="module", params=CURVES)
def curve_points(request):
    """Twelve points of random order-r multiples of G1, affine (Z = 1)."""
    ctx = make_context(request.param)
    rng = random.Random(381)
    pts = [ch.scalar_mul(ctx.g1, rng.randrange(1, ctx.curve.fr.modulus)) for _ in range(12)]
    return ctx, [(int(x), int(y)) for x, y in pts]


def test_ec_add_matches_jax_at_24_limbs(curve_points):
    ctx, pts = curve_points
    spec = ctx.fq_spec
    assert spec.n_limbs == 24
    b3 = ec.b3_const(spec, ctx.curve.b, device="cpu")
    assert b3.value == {"bls12_381": 12, "bls12_377": 3}[ctx.name]
    p = spec.modulus
    neg = (pts[1][0], p - pts[1][1])
    pa = [None, pts[2], pts[0], pts[1], None] + pts[3:7]
    pb = [pts[2], None, pts[0], neg, None] + pts[7:11]
    P = torch.from_numpy(ec.from_affine_host(spec, pa).astype(np.int32))
    Q = torch.from_numpy(ec.from_affine_host(spec, pb).astype(np.int32))
    R = ec.add(spec, b3, P, Q)
    R2 = ec.add(spec, b3, R, P.flip(0))  # projective (Z != 1) inputs

    jspec = jax_make_context(ctx.name).fq_spec
    jb3 = jec.b3_const(jspec, ctx.curve.b)
    add = jax.jit(lambda b, x, y: jec.add(jspec, b, x, y))
    j1 = add(jb3, _j(P), _j(Q))
    j2 = add(jb3, j1, _j(P.flip(0)))
    np.testing.assert_array_equal(R.numpy(), np.asarray(j1).astype(np.int32))
    np.testing.assert_array_equal(R2.numpy(), np.asarray(j2).astype(np.int32))

    Fq = ctx.Fq
    host = lambda pt: None if pt is None else (Fq(pt[0]), Fq(pt[1]))
    for x, y, got in zip(pa, pb, ec.to_affine_host(spec, R)):
        want = ch.add(host(x), host(y))
        assert got == (None if want is None else (int(want[0]), int(want[1])))
    assert ec.to_affine_host(spec, R[3:5]) == [None, None]  # P + (-P), O + O


ACC_N, ACC_C, ACC_G = 68, 4, 8


def test_bucket_accumulate_matches_jax_at_24_limbs():
    """K4a's plain version on BLS12-381's base field (3b = 12), bit for bit
    against the reference's buckets (identity padding from 68 to 72
    points)."""
    curve = "bls12_381"
    ctx = make_context(curve)
    ck, _ = kzg.setup(ctx, max_degree=ACC_N - 1, tau=4243, device="cpu")
    r = ctx.curve.fr.modulus
    rng = random.Random(8)
    scalars = [rng.randrange(r) for _ in range(ACC_N)]
    # 0xFFFF: window 0 is 15 > 8, so window 1 is 15 + 1 = 16, a negative zero
    scalars[:5] = [0, 1, r - 1, 0xFFFF, (r - 1) // 2]
    S = _t(scalars, 16).reshape(1, ACC_N, 16)
    got = msm._accumulate(ctx.fq_spec, ck.b3, ck.msm_points, S, r.bit_length(), ACC_C, ACC_G)

    jspec = jax_make_context(curve).fq_spec
    jb3 = jec.b3_const(jspec, ctx.curve.b)
    want = jax.jit(lambda p, s: jmsm._accumulate(jspec, jb3, p, s, r.bit_length(), ACC_C, ACC_G))(
        _j(ck.powers), _j(S[0])
    )
    want = np.asarray(want).astype(np.int32)  # (W, G, K, 3, L)
    assert got.shape == (ACC_G,) + want.shape[:1] + want.shape[2:]
    np.testing.assert_array_equal(got.numpy(), want.transpose(1, 0, 2, 3, 4))


DIRECTIONS = ["fft", "ifft", "coset_fft", "coset_ifft"]


@pytest.mark.parametrize("params", [BLS12_381_FR, BLS12_377_FR], ids=lambda f: f.name)
def test_transforms_match_jax(params):
    p = params.modulus
    for logn in (6, 9):
        n = 1 << logn
        rng = random.Random(logn)
        X = _t([rng.randrange(p) for _ in range(2 * n)], 16).reshape(2, n, 16)
        jdom = jax_make_domain(params, n)
        run = jax.jit(lambda pl, v: tuple(getattr(jntt, d)(jdom.spec, pl, v) for d in DIRECTIONS))
        want = run(jdom.plan(), _j(X))
        dom = make_domain(params, n)
        plan = dom.plan("cpu")
        for d, w in zip(DIRECTIONS, want):
            got = getattr(ntt, d)(dom.spec, plan, X)
            np.testing.assert_array_equal(got.numpy(), np.asarray(w).astype(np.int32))


def test_pow_chain_matches_jax_on_bls12_381_fr():
    """K2's plain version on the field whose card instance runs the strict
    mode: e = r - 2 (the prover's inversion) and e = 5 (the Poseidon
    S-box), on 0, 1, r - 1 and random elements."""
    params = BLS12_381_FR
    spec = make_spec(params)
    r = params.modulus
    rng = random.Random(255)
    xs = [0, 1, r - 1, (r - 1) // 2] + [rng.randrange(r) for _ in range(4)]
    X = _t(xs, 16)
    jspec = jax_make_spec(params)
    for e in (r - 2, 5):
        got = tfc.pow_chain_plain(spec, X, e)
        want = jpallas.pow_chain(jspec, _j(X), e, interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int32))
        assert array_to_ints(got.numpy()) == [pow(x, e, r) for x in xs]
    assert array_to_ints(tfd.inv(spec, X).numpy()) == [pow(x, r - 2, r) for x in xs]


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


def test_bls12_381_kzg_proof_bytes_match_jax():
    """``tests/test_e2e.py:test_full_prove_verify_bls_curves`` (BLS12-381,
    tau 24680, seed 12) in both packages: the same 1010 bytes."""
    curve, tau, seed = "bls12_381", 24680, 12
    jinst = JZKTPlonk(
        curve=curve, table=JLookupTable([1, 2, 5], size=4),
        transcript_factory=lambda label: JMerlinTranscript(label, coord_bytes=48),
    )
    jck, jcvk = jkzg.setup(jax_make_context(curve), max_degree=64, tau=tau)
    jcompiled = jinst.compile(SmallCircuitDef(jlt), jck, jcvk)
    jproof = jinst.prove(jcompiled, SmallCircuitDef(jlt), random.Random(seed))
    want = jarkserde.proof_to_bytes(jproof, jinst.ctx.curve.fq.modulus, jinst.ctx.curve.fr.modulus)

    inst = ZKTPlonk(
        curve=curve, table=LookupTable([1, 2, 5], size=4), device="cpu",
        transcript_factory=lambda label: MerlinTranscript(label, coord_bytes=48),
    )
    ck, cvk = kzg.setup(inst.ctx, max_degree=64, tau=tau, device="cpu")
    compiled = inst.compile(SmallCircuitDef(lt), ck, cvk)
    proof = inst.prove(compiled, SmallCircuitDef(lt), random.Random(seed))
    blob = arkserde.proof_to_bytes(proof, inst.ctx.curve.fq.modulus, inst.ctx.curve.fr.modulus)
    assert len(blob) == 1010
    assert blob == want, hashlib.sha256(blob).hexdigest()

    inst.verify(compiled, proof, [6])
    with pytest.raises((VerificationError, AssertionError)):
        inst.verify(compiled, proof, [7])
    tampered = copy.deepcopy(proof)
    tampered.evaluations.a = (tampered.evaluations.a + 1) % inst.p
    with pytest.raises(VerificationError):
        inst.verify(compiled, tampered, [6])
