"""The Z = 1 points that K4a takes, on BN254 (L = 16) and BLS12-381
(L = 24).

* ``ec.normalize`` of small-SRS points scaled to (lX : lY : lZ) by random
  factors gives back the points bit for bit, and their host affine points
  are the JAX package's SRS points; a point with Z = 0 raises;
* ``msm.bucket_accumulate`` raises on a point with Z != 1 and on a window
  past its instance's shared memory;
* ``msm.msm_totals`` over the copy gives window totals that fold to what
  ``msm.msm`` gives over the scaled points and to the JAX package's host
  MSM; ``msm_totals``, ``commit_rows``, ``parallel.ops.pmsm_totals`` and
  ``pcommit_totals`` refuse a bare points tensor (TypeError);
* ``msm.msm`` over points that hold the identity (Z = 0) drops it with its
  scalar, and equals the JAX package's ``msm_totals`` + ``fold_windows_host``:
  a lone identity with scalar 1 gives None, 7 SRS points and the identity
  with random scalars an affine point;
* ``kzg.Committer`` on a key of scaled points commits through the copy,
  built once per key and shared by its committers, and equals the JAX
  package's commitments over the same scaled points; the IPA generators'
  copy is the generators themselves, and ``ipa.commit(device=True)``
  commits over it as the host MSM does.
"""

import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkt_plonk_tpu.commitment import kzg as jkzg
from zkt_plonk_tpu.curves import curve_host as jch
from zkt_plonk_tpu.curves import make_context as jax_make_context
from zkt_plonk_tpu.ops import ec as jec
from zkt_plonk_tpu.ops import msm as jmsm
from zkt_plonk_tpu_torch.commitment import ipa, kzg
from zkt_plonk_tpu_torch.curves import make_context
from zkt_plonk_tpu_torch.fields import device as fd
from zkt_plonk_tpu_torch.fields.limbs import array_to_ints, ints_to_array
from zkt_plonk_tpu_torch.ops import ec, msm
from zkt_plonk_tpu_torch.parallel import ops as pops
from zkt_plonk_tpu_torch.parallel.mesh import Mesh

N, TAU = 68, 4242


@pytest.fixture(scope="module", params=["bn254", "bls12_381"])
def scaled(request):
    """A small SRS (Z = 1) and the same points scaled by random factors l:
    (lX : lY : l)."""
    ctx = make_context(request.param)
    ck, _ = kzg.setup(ctx, max_degree=N - 1, tau=TAU, device="cpu")
    p = ctx.fq_spec.modulus
    L = ctx.fq_spec.n_limbs
    rng = np.random.default_rng(68)
    lam = [int.from_bytes(rng.bytes(2 * L), "little") % (p - 1) + 1 for _ in range(N)]
    lam_limbs = torch.from_numpy(ints_to_array(lam, L).astype(np.int32))
    return ctx, ck, fd.mul(ctx.fq_spec, ck.powers, lam_limbs[:, None])


def _scalars(ctx, count, seed):
    r = ctx.curve.fr.modulus
    rng = random.Random(seed)
    vals = [rng.randrange(r) for _ in range(count)]
    vals[:3] = [0, 1, r - 1]
    return torch.from_numpy(ints_to_array(vals, 16).astype(np.int32))


def test_normalize_gives_the_points_and_the_jax_srs(scaled):
    ctx, ck, pts = scaled
    spec = ctx.fq_spec
    assert not torch.equal(pts[:, 2], ck.powers[:, 2])
    copy = ec.normalize(spec, pts)
    assert torch.equal(copy, ck.powers)
    jctx = jax_make_context(ctx.name)
    jck, _ = jkzg.setup(jctx, max_degree=N - 1, tau=TAU)
    want = jec.to_affine_host(jctx.fq_spec, np.asarray(jck.powers))
    assert ec.to_affine_host(spec, copy) == [(int(x), int(y)) for x, y in want]


def test_normalize_refuses_the_identity(scaled):
    ctx, _, pts = scaled
    with_identity = torch.cat([pts[:3], ec.identity(ctx.fq_spec, (1,), device="cpu")])
    with pytest.raises(ValueError, match="Z = 0"):
        ec.normalize(ctx.fq_spec, with_identity)


def test_affine_accumulate_refuses_points_without_z_one(scaled):
    ctx, ck, pts = scaled
    spec = ctx.fq_spec
    digits = torch.zeros((2, 72), dtype=torch.int16)
    with pytest.raises(ValueError, match="Z = 1"):
        msm.bucket_accumulate(spec, ck.b3, pts, digits, 8, 4)
    # the masks of a wider window and the L = 24 instance's staged values
    # would pass 48 KB of shared memory a block
    c = msm.ACC_MAX_C[spec.n_limbs] + 1
    with pytest.raises(ValueError, match=f"windows up to c = {c - 1}"):
        msm.bucket_accumulate(spec, ck.b3, ck.powers, digits, 8, c)


def test_msm_totals_over_the_copy_match_the_scaled_points(scaled):
    ctx, ck, pts = scaled
    spec = ctx.fq_spec
    S = _scalars(ctx, N, 5)
    fr_bits = ctx.curve.fr.modulus.bit_length()
    copy = msm.commit_points(spec, pts)
    totals = msm.msm_totals(spec, ck.b3, copy, S, fr_bits, c=4, groups=8)
    got = msm.fold_windows_host(spec, ctx.Fq, totals, 4)
    assert got == msm.msm(spec, ctx.Fq, ck.b3, pts, S, fr_bits, c=4)
    jctx = jax_make_context(ctx.name)
    want = jch.msm([(jctx.Fq(x), jctx.Fq(y)) for x, y in ec.to_affine_host(spec, pts)],
                   array_to_ints(S.numpy()))
    assert got == (int(want[0]), int(want[1]))


@pytest.mark.parametrize("entry", ["msm_totals", "commit_rows", "pmsm_totals", "pcommit_totals"])
def test_msm_entry_points_refuse_a_bare_tensor(scaled, entry):
    """The MSM takes its points as a CommitPoints only; a bare tensor raises
    before any work (pcommit_totals: a CommitPoints body, a bare tail)."""
    ctx, ck, pts = scaled
    spec = ctx.fq_spec
    S = _scalars(ctx, N, 6)
    fr_bits = ctx.curve.fr.modulus.bit_length()
    mesh = Mesh(group=None, ranks=(0,), device=torch.device("cpu"), backend="gloo")
    body = msm.CommitPoints(ck.powers[: N - 4])
    calls = {
        "msm_totals": lambda: msm.msm_totals(spec, ck.b3, pts, S, fr_bits),
        "commit_rows": lambda: msm.commit_rows(ctx, ck.b3, pts, S[None]),
        "pmsm_totals": lambda: pops.pmsm_totals(spec, ck.b3, pts, S, fr_bits, mesh),
        "pcommit_totals": lambda: pops.pcommit_totals(spec, ck.b3, body, pts[N - 4:], S[: N - 4],
                                                      S[N - 4:], fr_bits, 4, mesh),
    }
    with pytest.raises(TypeError, match="CommitPoints"):
        calls[entry]()


@functools.lru_cache(maxsize=None)
def _jax_msm_totals(curve):
    """The JAX package's ``msm_totals`` at c = 4, jitted once per curve."""
    jctx = jax_make_context(curve)
    jspec = jctx.fq_spec
    b3 = jec.b3_const(jspec, jctx.curve.b)
    fr_bits = jctx.curve.fr.modulus.bit_length()
    return jctx, jax.jit(lambda p, s: jmsm.msm_totals(jspec, b3, p, s, fr_bits, c=4))


@pytest.mark.parametrize("case", ["identity-alone", "seven-and-identity"])
def test_msm_over_the_identity_matches_jax(scaled, case):
    """A lone identity with scalar 1 (JAX: None), and 7 SRS points (scaled
    to Z != 1) with the identity among them, random scalars."""
    ctx, ck, pts = scaled
    spec = ctx.fq_spec
    r = ctx.curve.fr.modulus
    identity = ec.identity(spec, (1,), device="cpu")
    if case == "identity-alone":
        points, vals = identity, [1]
    else:
        points = torch.cat([pts[:3], identity, pts[3:7]])
        rng = random.Random(7)
        vals = [rng.randrange(r) for _ in range(8)]
    S = torch.from_numpy(ints_to_array(vals, 16).astype(np.int32))
    got = msm.msm(spec, ctx.Fq, ck.b3, points, S, r.bit_length())
    # the JAX MSM pads its points to its G = 8 groups with identity rows and
    # zero digits; padding the lone identity so here gives both cases one
    # shape, so one compile per curve
    pad = 8 - points.shape[0]
    jpts = torch.cat([points, ec.identity(spec, (pad,), device="cpu")]).numpy().astype(np.uint32)
    jS = torch.nn.functional.pad(S, (0, 0, 0, pad)).numpy().astype(np.uint32)
    jctx, jax_totals = _jax_msm_totals(ctx.name)
    totals = np.asarray(jax_totals(jnp.asarray(jpts), jnp.asarray(jS)))
    want = jmsm.fold_windows_host(jctx.fq_spec, jctx.Fq, totals, 4)
    assert (want is None) == (case == "identity-alone")
    assert got == want


def test_committer_commits_through_the_keys_copy_as_jax_does(scaled):
    ctx, ck, pts = scaled
    key = kzg.CommitterKey(ctx=ctx, powers=pts, b3=ck.b3)
    polys = torch.stack([_scalars(ctx, N, 11), _scalars(ctx, N, 12)])
    got = kzg.Committer(key).commit_many(polys)
    assert isinstance(key.__dict__["msm_points"], msm.CommitPoints)
    copy = key.msm_points.points
    assert kzg.Committer(key).ck.msm_points.points is copy  # one copy per key
    jctx = jax_make_context(ctx.name)
    jkey = jkzg.CommitterKey(ctx=jctx, powers=pts.numpy().astype(np.uint32),
                             b3=jec.b3_const(jctx.fq_spec, jctx.curve.b))
    assert got == jkzg.Committer(jkey).commit_many(polys.numpy().astype(np.uint32))


def test_ipa_generators_copy_is_the_generators():
    ck, _ = ipa.setup("bn254", max_degree=7, device="cpu")
    (points,) = ck.msm_points
    assert torch.equal(points, ck.gens_dev)
    rng = random.Random(13)
    coeffs = [rng.randrange(ck.ctx.curve.fr.modulus) for _ in range(8)]
    assert ipa.commit(ck, coeffs, device=True) == ipa.commit(ck, coeffs)  # over the copy
