"""The port's EC add (plain CPU version of kernel K4) and MSMs against the
JAX package.

* ``ec.add`` against jitted ``zkt_plonk_tpu.ops.ec.add`` as projective limbs
  on identity, doubling, P + (-P), random pairs and projective (Z != 1)
  inputs;
* ``msm`` against ``zkt_plonk_tpu.curves.host.msm`` as affine ints at 68
  points, on BN254 and on BLS12-381 (K4a's L = 24 instance);
* the bucket group rule ``msm.group_count`` at the prover's commit
  batches, per instance from its resident rows;
* ``fixed_base_msm`` at 16 scalars against host scalar multiplication;
* the digit rows (plain CPU version of kernel K5, ``digit_rows``) against
  ``zkt_plonk_tpu.ops.msm.signed_window_digits`` on BN254's and
  BLS12-381's Fr at c = 4 and 8, B = 1 and 3, with padding columns;
* the bucket accumulation (plain CPU version of kernel K4a) against
  ``zkt_plonk_tpu.ops.msm._accumulate`` as bucket limbs, bit for bit, at
  n = 68, c = 4, G = 8 (identity padding to 72 points), on random scalars
  with 0, 1, r - 1 and a negative-zero digit, and on scalars that hit one
  bucket on consecutive steps; a batch of two against two single calls;
  and the bucket sums at G = 16 against the reference's;
* the wrappers' checks that need no card: digit codes out of range, the
  moduli the kernels' word arithmetic can take (at L = 16 and, for the
  BLS12 base fields, L = 24) and the reduction mode of K2 and K3, and the
  names of the per-instance launch counters.
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
from zkt_plonk_tpu.ops import msm as jmsm
from zkt_plonk_tpu_torch import _cuda
from zkt_plonk_tpu_torch.commitment import kzg
from zkt_plonk_tpu_torch.curves import make_context
from zkt_plonk_tpu_torch.fields import make_spec
from zkt_plonk_tpu_torch.fields.limbs import ints_to_array
from zkt_plonk_tpu_torch.fields.params import (
    BLS12_377_FQ, BLS12_381_FQ, BLS12_381_FR, BN254_FQ, BN254_FR, FieldParams,
)
from zkt_plonk_tpu_torch.ops import ec, msm
from zkt_plonk_tpu_torch.utils.scan import tree_reduce

# the G rule's picks at L = 24 for B = 1, 2, 3, 6, 10, from K4a's L = 24
# residency in msm.ACC_RESIDENT_BLOCKS
L24_GROUPS = (1024, 512, 512, 256, 128)


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
    points = msm.commit_points(ctx.fq_spec, ck.powers)
    totals = msm.msm_totals(ctx.fq_spec, ck.b3, points, S, fr_bits, c=c, groups=groups)
    assert msm.fold_windows_host(ctx.fq_spec, ctx.Fq, totals, c) == want


# The G rule at the prover's commit batches B = 1, 2, 3, 6, 10 (n = 2^18 + 4,
# c = 8, 32 windows on BN254 and BLS12-381): at L = 16 the picks of the
# L = 16 sweep; at L = 24 those that its instance's resident rows imply
# (msm.ACC_RESIDENT_BLOCKS); and at L = 24 with 2 resident blocks, the
# residency of the 240-register instance, the picks its sweep found best
# (PERF.md).
@pytest.mark.parametrize(
    "limbs, blocks, want",
    [(16, None, (1024, 512, 512, 256, 128)), (24, None, L24_GROUPS),
     (24, 2, (1024, 512, 256, 128, 64))],
    ids=["L16", "L24", "L24-two-blocks"],
)
def test_group_rule_counts_each_instances_resident_rows(monkeypatch, limbs, blocks, want):
    if blocks is not None:
        monkeypatch.setitem(msm.ACC_RESIDENT_BLOCKS, limbs, blocks)
    n, c = (1 << 18) + 4, 8
    for fr_bits in (254, 255):
        W = msm.num_windows(fr_bits + 1, c)
        assert W == 32
        assert tuple(msm.group_count(n, c, B, W, limbs) for B in (1, 2, 3, 6, 10)) == want


def test_msm_over_bls12_381_matches_jax_host_msm():
    """msm.msm on BLS12-381 points (K4a's L = 24 instance, G from its rule)
    against the JAX package's host MSM."""
    ctx = make_context("bls12_381")
    ck, _ = kzg.setup(ctx, max_degree=67, tau=4242, device="cpu")
    r = ctx.curve.fr.modulus
    rng = random.Random(381)
    scalars = [0, 1, r - 1] + [rng.randrange(r) for _ in range(65)]
    S = torch.from_numpy(ints_to_array(scalars, 16).astype(np.int32))
    got = msm.msm(ctx.fq_spec, ctx.Fq, ck.b3, ck.powers, S, r.bit_length())
    jctx = jax_make_context("bls12_381")
    pts = [None if p is None else (jctx.Fq(p[0]), jctx.Fq(p[1]))
           for p in ec.to_affine_host(ctx.fq_spec, ck.powers)]
    want = jch.msm(pts, scalars)
    assert got == (int(want[0]), int(want[1]))


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


ACC_N, ACC_C, ACC_G = 68, 4, 8


def _bucket_scalars(kind, r):
    rng = random.Random(7)
    if kind == "random":
        s = [rng.randrange(r) for _ in range(ACC_N)]
        # 0xFFFF: window 0 is 15 > 8, so window 1 is 15 + 1 = 16, a negative zero
        s[:5] = [0, 1, r - 1, 0xFFFF, (r - 1) // 2]
    else:
        # every point of group g (g, g + G, ...) gets scalar base[g]: each
        # bucket row sees the same digit on all of its consecutive steps;
        # groups 4..7 repeat digits in runs of two
        base = [rng.randrange(r) for _ in range(ACC_G)]
        s = [base[i % ACC_G] if i % ACC_G < 4 else base[(i // (2 * ACC_G)) % ACC_G] for i in range(ACC_N)]
    return s


@pytest.fixture(scope="module")
def jax_buckets(srs):
    """The reference's (W, G, K, 3, L) buckets for each scalar kind."""
    ctx, ck = srs
    jspec = jax_make_context("bn254").fq_spec
    b3 = jec.b3_const(jspec, 3)
    r = ctx.curve.fr.modulus
    fn = jax.jit(lambda p, s: jmsm._accumulate(jspec, b3, p, s, r.bit_length(), ACC_C, ACC_G))
    pts = jnp.asarray(ck.powers.numpy().astype(np.uint32))
    out = {}
    for kind in ("random", "runs"):
        sc = ints_to_array(_bucket_scalars(kind, r), 16).astype(np.uint32)
        out[kind] = np.asarray(fn(pts, jnp.asarray(sc))).astype(np.int32)
    return out


def _port_buckets(ctx, ck, scalars, G):
    S = torch.from_numpy(ints_to_array(scalars, 16).astype(np.int32)).reshape(-1, ACC_N, 16)
    fr_bits = ctx.curve.fr.modulus.bit_length()
    return msm._accumulate(ctx.fq_spec, ck.b3, ck.msm_points, S, fr_bits, ACC_C, G)


@pytest.mark.parametrize("kind", ["random", "runs"])
def test_bucket_accumulate_matches_jax_bit_for_bit(srs, jax_buckets, kind):
    ctx, ck = srs
    got = _port_buckets(ctx, ck, _bucket_scalars(kind, ctx.curve.fr.modulus), ACC_G)
    want = jax_buckets[kind]  # (W, G, K, 3, L)
    assert got.shape == (ACC_G,) + want.shape[:1] + want.shape[2:]
    np.testing.assert_array_equal(got.numpy(), want.transpose(1, 0, 2, 3, 4))


def test_signed_digit_codes_keep_negative_zero():
    S = torch.from_numpy(ints_to_array([0xFFFF, 0xFF, 8, 9], 16).astype(np.int32))
    codes = msm.signed_digit_codes(S, 4, 254)
    # 0xFFFF: -1 (carry), then 15 + 1 = 16 -> negative zero, ...; 0xFF: -1, 0 + ...
    assert codes[:3, 0].tolist() == [~1, ~0, ~0]
    assert codes[:3, 1].tolist() == [~1, ~0, 1]
    assert codes[:2, 2].tolist() == [8, 0]
    assert codes[:2, 3].tolist() == [~7, 1]


def _runs(c, bits, digits):
    """The integer whose c-bit windows below ``bits`` are ``digits`` in turn."""
    return sum(digits[w % len(digits)] << (c * w) for w in range(bits // c))


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("c", [4, 8])
@pytest.mark.parametrize("field", [BN254_FR, BLS12_381_FR], ids=lambda f: f.name)
def test_digit_rows_match_jax_signed_window_digits(field, c, B):
    """``digit_rows``' plain version against the JAX recoding, its
    (magnitude, negate) pairs coded m or ~m: row b*W + w, the padding
    columns n..n_pad zero.  Scalars 0, 1, r - 1, every window 2^(c-1) (no
    carry), 2^(c-1) + 1 then 2^(c-1) (a carry through every window),
    2^c - 1 (negative zeros) and random ones; n = 37 is not a multiple of
    G = 8.  The work counter counts every code, padding included."""
    r = field.modulus
    fr_bits = r.bit_length()
    n, G = 37, 8
    half, full = 1 << (c - 1), 1 << c
    bits = fr_bits - 2
    rng = random.Random(fr_bits * c + B)
    vals = [0, 1, r - 1, _runs(c, bits, [half]), _runs(c, bits, [half + 1] + [half] * 80),
            _runs(c, bits, [full - 1]), _runs(c, bits, [half + 1, half, full - 1])]
    vals += [rng.randrange(r) for _ in range(B * n - len(vals))]
    S = ints_to_array(vals, 16).astype(np.int32)
    codes0 = _cuda.work["msm_digit_codes"]
    got = msm.digit_rows(torch.from_numpy(S).reshape(B, n, 16), c, fr_bits, G)
    assert _cuda.work["msm_digit_codes"] - codes0 == got.numel()
    mags, negs = jmsm.signed_window_digits(jnp.asarray(S.astype(np.uint32)), c, fr_bits)
    mags = np.asarray(mags).astype(np.int64)
    codes = np.where(np.asarray(negs), ~mags, mags)  # (W, B*n)
    W = codes.shape[0]
    assert W == msm.num_windows(fr_bits + 1, c)
    assert got.dtype == torch.int16 and got.shape == (B * W, 40)
    np.testing.assert_array_equal(got[:, :n].numpy(),
                                  codes.reshape(W, B, n).transpose(1, 0, 2).reshape(B * W, n))
    assert not got[:, n:].any()


def test_bucket_accumulate_batch_matches_single_calls(srs):
    ctx, ck = srs
    r = ctx.curve.fr.modulus
    rng = random.Random(11)
    scalars = [rng.randrange(r) for _ in range(2 * ACC_N)]
    both = _port_buckets(ctx, ck, scalars, ACC_G)  # (G, 2W, K, 3, L)
    W = both.shape[1] // 2
    for b in range(2):
        one = _port_buckets(ctx, ck, scalars[b * ACC_N:(b + 1) * ACC_N], ACC_G)
        assert torch.equal(both[:, b * W:(b + 1) * W], one)


def test_bucket_sums_with_more_padding_match_jax(srs, jax_buckets):
    """G = 16 pads 68 points to 80 with the identity: the buckets differ from
    the reference's G = 8 ones, their sums over the groups do not."""
    ctx, ck = srs
    spec = ctx.fq_spec
    got = _port_buckets(ctx, ck, _bucket_scalars("random", ctx.curve.fr.modulus), 16)
    add = lambda a, b: ec.add(spec, ck.b3, a, b)
    got_sum = tree_reduce(add, got, 0)  # (W, K, 3, L)
    want = torch.from_numpy(np.ascontiguousarray(jax_buckets["random"].transpose(1, 0, 2, 3, 4)))
    want_sum = tree_reduce(add, want, 0)
    assert ec.to_affine_host(spec, got_sum) == ec.to_affine_host(spec, want_sum)


def test_bucket_accumulate_rejects_digit_codes_out_of_range(srs):
    ctx, ck = srs
    K = (1 << (ACC_C - 1)) + 1
    digits = torch.zeros((2, 72), dtype=torch.int16)
    for bad in (K, ~K):
        digits[1, 5] = bad
        with pytest.raises(ValueError, match="out of range"):
            msm.bucket_accumulate(ctx.fq_spec, ck.b3, ck.powers, digits, ACC_G, ACC_C)


SECP256K1_FQ = FieldParams(name="secp256k1_fq", modulus=2**256 - 2**32 - 977, generator=3, two_adicity=1)


@pytest.mark.parametrize(
    "params, field_ok, ec_ok",
    [(BN254_FQ, True, True), (BN254_FR, True, True), (BLS12_381_FR, True, False),
     (SECP256K1_FQ, False, False), (BLS12_381_FQ, True, True), (BLS12_377_FQ, True, True)],
    ids=lambda v: getattr(v, "name", None),
)
def test_kernel_constants_check_the_modulus(params, field_ok, ec_ok):
    """The field kernels need 2p < R = 2^(16 L), the EC kernels' lazy
    reduction 5p < R (BN254's Fq at L = 16, the BLS12 base fields at
    L = 24); a modulus without that headroom is refused before any launch.
    K2 and K3 run lazily where 4p < R and strictly where only 2p < R."""
    spec = make_spec(params)
    nw = spec.n_limbs // 2
    for fn, ok in ((_cuda.field_consts, field_ok), (_cuda.ec_field_consts, ec_ok)):
        if ok:
            words = list(fn(spec))
            assert len(words) == 5 * nw + 1
            assert sum(w << (32 * i) for i, w in enumerate(words[:nw])) == params.modulus
        else:
            with pytest.raises(ValueError, match="need"):
                fn(spec)
    if field_ok:
        strict, words = _cuda.reduction_consts(spec)
        assert strict == (not ec_ok) and list(words) == list(_cuda.field_consts(spec))
    else:
        with pytest.raises(ValueError, match="need"):
            _cuda.reduction_consts(spec)


def test_launch_counters_name_each_instance():
    assert _cuda.instance("ec_add_complete") == "ec_add_complete"
    assert _cuda.instance("ec_bucket_accumulate", 24) == "ec_bucket_accumulate/L24"
    assert _cuda.instance("ntt_col_pass", strict=True) == "ntt_col_pass/strict"
    assert set(_cuda.launches) == set(_cuda.INSTANCES)
    with pytest.raises(ValueError, match="no instance"):
        _cuda.instance("ntt_col_pass", 24)
