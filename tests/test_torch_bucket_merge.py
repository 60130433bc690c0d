"""The MSM's group merge (plain CPU version of kernel K6, ``bucket_merge``).

``msm.bucket_merge`` and ``msm.bucket_merge_plain`` at 1, 2 and 3 chunks
against ``tree_reduce`` of ``ec.add`` over the same (G, BW, K, 3, L)
buckets: equal as affine points in every column (bw, k >= 1), row k = 0
the identity's limbs, on BN254 (L = 16), BLS12-381 and BLS12-377 (L = 24),
at G = 1, 2, 3, 5, 8 and 64 groups and windows of c = 4 and 8 bits.  The
buckets hold the identity, runs of one point (doublings inside a chunk and
between chunks' sums), a point beside its negation (P + (-P)) and random
points, each with a random Z; the work counter ``ec_merge_adds`` counts
(G - 1) x BW x (K - 1) a call.
"""

import os
import random

import numpy as np
import pytest
import torch

from zkt_plonk_tpu_torch import _cuda
from zkt_plonk_tpu_torch.curves import curve_host as ch
from zkt_plonk_tpu_torch.curves import make_context
from zkt_plonk_tpu_torch.fields.limbs import ints_to_array
from zkt_plonk_tpu_torch.ops import ec, msm
from zkt_plonk_tpu_torch.utils.scan import tree_reduce

CURVES = ("bn254", "bls12_381", "bls12_377")


@pytest.fixture(scope="module", autouse=True)
def _share_cores_with_xdist_workers():
    """Each pytest-xdist worker takes its share of the cores for the plain
    versions' many small torch ops while this module runs."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def point_pools():
    """Per curve: its context and a few random affine points."""
    pools = {}
    for curve in CURVES:
        ctx = make_context(curve)
        rng = random.Random(len(curve))
        r = ctx.curve.fr.modulus
        pools[curve] = ctx, [ch.scalar_mul(ctx.g1, rng.randrange(1, r)) for _ in range(6)]
    return pools


def merge_buckets(ctx, pool, G, BW, K, rng):
    """(G, BW, K, 3, L) buckets of canonical limbs, column patterns in turn:
    every group the identity; one point among identities; one point in
    every group; a point and its negation in turns; random points."""
    p = ctx.fq_spec.modulus
    ident = (0, 1, 0)

    def proj(pt):
        if pt is None:
            return ident
        z = rng.randrange(1, p)
        return (int(pt[0]) * z % p, int(pt[1]) * z % p, z)

    cols = []
    for col in range(BW * K):
        P = pool[col % len(pool)]
        pattern = col % 5
        if pattern == 0:
            pts = [None] * G
        elif pattern == 1:
            pts = [None] * G
            pts[rng.randrange(G)] = P
        elif pattern == 2:
            pts = [P] * G
        elif pattern == 3:
            pts = [P if g % 2 == 0 else ch.neg(P) for g in range(G)]
        else:
            pts = [rng.choice(pool + [None]) for _ in range(G)]
        cols.append([proj(pt) for pt in pts])
    vals = [c for g in range(G) for col in cols for c in col[g]]
    L = ctx.fq_spec.n_limbs
    return torch.from_numpy(ints_to_array(vals, L).astype(np.int32)).reshape(G, BW, K, 3, L)


@pytest.mark.parametrize("c", [4, 8])
@pytest.mark.parametrize("G", [1, 2, 3, 5, 8, 64])
@pytest.mark.parametrize("curve", CURVES)
def test_bucket_merge_matches_tree_reduce(point_pools, curve, G, c):
    ctx, pool = point_pools[curve]
    spec = ctx.fq_spec
    b3 = ec.b3_const(spec, int(ctx.curve.b), device="cpu")
    K = (1 << (c - 1)) + 1
    BW = 2
    buckets = merge_buckets(ctx, pool, G, BW, K, random.Random(G * 100 + c))
    want = ec.to_affine_host(spec, tree_reduce(lambda a, b: ec.add(spec, b3, a, b), buckets, 0)[:, 1:])
    ident = ec.identity(spec, (BW,), device="cpu")

    adds0 = _cuda.work["ec_merge_adds"]
    got = {"rule": msm.bucket_merge(spec, b3, buckets)}
    assert _cuda.work["ec_merge_adds"] - adds0 == (G - 1) * BW * (K - 1)
    for chunks in sorted({1, 2, 3} & set(range(1, G + 1))):
        got[chunks] = msm.bucket_merge_plain(spec, b3, buckets, chunks)
    for chunks, out in got.items():
        assert out.shape == (BW, K, 3, spec.n_limbs) and out.dtype == torch.int32, chunks
        assert torch.equal(out[:, 0], ident), chunks
        assert ec.to_affine_host(spec, out[:, 1:]) == want, chunks


def test_bucket_merge_rejects_what_the_kernel_does_not_take(point_pools):
    ctx, pool = point_pools["bn254"]
    spec = ctx.fq_spec
    b3 = ec.b3_const(spec, int(ctx.curve.b), device="cpu")
    good = merge_buckets(ctx, pool, 2, 1, 3, random.Random(1))
    for bad, why in ((good.to(torch.int64), "int32"), (good[0], r"\(G, BW, K, 3, 16\)"),
                     (good[:, :, :1], "K >= 2"), (good.to("meta"), "buckets on meta")):
        with pytest.raises(ValueError, match=why):
            msm.bucket_merge(spec, b3, bad)


def test_merge_chunks_fill_one_wave():
    """At the prover's batches (n = 2^18 + 4, c = 8, 32 windows), the chunks
    fill one wave of K6's resident threads at each width; few columns take
    sqrt(G) chunks; G = 1 takes one."""
    for L in (16, 24):
        resident = msm.MERGE_RESIDENT_BLOCKS[L] * msm.MERGE_THREADS * msm.ACC_SMS
        for B, G in zip((1, 2, 3, 6), (1024, 512, 512, 256)):
            cols = B * 32 * 128
            C = msm.merge_chunks(G, cols, L)
            assert C * cols <= resident < (C + 1) * cols and 1 < C < G
        assert msm.merge_chunks(128, 512, L) == 11 and msm.merge_chunks(5, 1, L) == 2
        assert msm.merge_chunks(1, 8, L) == 1 and msm.merge_chunks(1024, 10 ** 6, L) == 1
