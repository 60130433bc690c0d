"""The port's EC add (plain CPU version of kernel K4) and MSMs against the
JAX package.

* ``ec.add`` against jitted ``zkt_plonk_tpu.ops.ec.add`` as projective limbs
  on identity, doubling, P + (-P), random pairs and projective (Z != 1)
  inputs;
* ``msm`` against ``zkt_plonk_tpu.curves.host.msm`` as affine ints at 68
  points;
* ``fixed_base_msm`` at 16 scalars against host scalar multiplication.
"""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkt_plonk_tpu.curves import curve_host as jch
from zkt_plonk_tpu.curves import make_context as jax_make_context
from zkt_plonk_tpu.ops import ec as jec
from zkt_plonk_tpu_torch.commitment import kzg
from zkt_plonk_tpu_torch.curves import make_context
from zkt_plonk_tpu_torch.fields.limbs import ints_to_array
from zkt_plonk_tpu_torch.ops import ec, msm


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


@pytest.fixture(scope="module")
def srs():
    ctx = make_context("bn254")
    ck, _ = kzg.setup(ctx, max_degree=67, tau=4242, device="cpu")
    return ctx, ck


def _host_points(ctx, pts):
    jctx = jax_make_context("bn254")
    return [None if p is None else (jctx.Fq(p[0]), jctx.Fq(p[1]))
            for p in ec.to_affine_host(ctx.fq_spec, pts)]


def test_ec_add_matches_jax_projective_limbs(srs):
    ctx, ck = srs
    spec = ctx.fq_spec
    pts = ck.powers  # (68, 3, L), Z = 1
    ident = ec.identity(spec, (2,), device="cpu")
    P = torch.cat([ident, pts[:20], pts[5:6], pts[9:10]])
    Q = torch.cat([pts[:1], ident[:1], pts[20:40], pts[5:6], ec.neg(spec, pts[9:10])])
    R = ec.add(spec, ck.b3, P, Q)  # identity+P, P+identity, randoms, P+P, P+(-P)
    R2 = ec.add(spec, ck.b3, R, P.flip(0))  # projective (Z != 1) inputs

    jspec = jax_make_context("bn254").fq_spec
    b3 = jec.b3_const(jspec, 3)
    add = jax.jit(lambda b, x, y: jec.add(jspec, b, x, y))
    j1 = add(b3, jnp.asarray(P.numpy().astype(np.uint32)), jnp.asarray(Q.numpy().astype(np.uint32)))
    j2 = add(b3, j1, jnp.asarray(P.flip(0).numpy().astype(np.uint32)))
    np.testing.assert_array_equal(R.numpy(), np.asarray(j1).astype(np.int32))
    np.testing.assert_array_equal(R2.numpy(), np.asarray(j2).astype(np.int32))
    z_is_zero = (R[:, 2] == 0).all(-1)
    assert z_is_zero[-1] and not z_is_zero[-2]  # P + (-P) is the identity, P + P is not


@pytest.fixture(scope="module")
def msm_case(srs):
    ctx, ck = srs
    r = ctx.curve.fr.modulus
    rng = random.Random(68)
    scalars = [rng.randrange(r) for _ in range(68)]
    scalars[:3] = [0, 1, r - 1]
    want = jch.msm(_host_points(ctx, ck.powers), scalars)
    return scalars, (int(want[0]), int(want[1]))


@pytest.mark.parametrize("groups", [0, 8])
def test_msm_matches_host_msm(srs, msm_case, groups):
    ctx, ck = srs
    scalars, want = msm_case
    S = torch.from_numpy(ints_to_array(scalars, 16).astype(np.int32))
    fr_bits = ctx.curve.fr.modulus.bit_length()
    c = msm.msm_window_size(68)
    totals = msm.msm_totals(ctx.fq_spec, ck.b3, ck.powers, S, fr_bits, c=c, groups=groups)
    assert msm.fold_windows_host(ctx.fq_spec, ctx.Fq, totals, c) == want


def test_batched_msm_matches_single(srs):
    ctx, ck = srs
    r = ctx.curve.fr.modulus
    rng = random.Random(5)
    S = torch.from_numpy(
        ints_to_array([rng.randrange(r) for _ in range(2 * 68)], 16).astype(np.int32)
    ).reshape(2, 68, 16)
    got = kzg.Committer(ck).commit_many(S)
    fr_bits = r.bit_length()
    for i in range(2):
        assert got[i] == msm.msm(ctx.fq_spec, ctx.Fq, ck.b3, ck.powers, S[i], fr_bits)


def test_fixed_base_msm_matches_host(srs):
    ctx, ck = srs
    r = ctx.curve.fr.modulus
    rng = random.Random(16)
    scalars = [0, 1, r - 1] + [rng.randrange(r) for _ in range(13)]
    tables = torch.from_numpy(msm.fixed_base_tables(ctx, ctx.g1, c=8).astype(np.int32))
    S = torch.from_numpy(ints_to_array(scalars, 16).astype(np.int32))
    out = msm.fixed_base_msm(ctx.fq_spec, ck.b3, tables, S, r.bit_length(), c=8)
    jg1 = jax_make_context("bn254").g1
    want = [jch.scalar_mul(jg1, s) for s in scalars]
    want = [None if w is None else (int(w[0]), int(w[1])) for w in want]
    assert ec.to_affine_host(ctx.fq_spec, out) == want
