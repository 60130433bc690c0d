"""The port's NTT (``zkt_plonk_tpu_torch.ops.ntt`` over the mixed-radix
driver, plain CPU version of kernel K3) against the JAX package.

* the numpy plan tables against ``zkt_plonk_tpu.ops.ntt_mr.build_plan`` at
  2^10 in all four directions;
* fft / ifft / coset_fft / coset_ifft against jitted ``zkt_plonk_tpu.ops.ntt``
  at 2^6 (one pass) and 2^9 (two passes), and against the host-int NTTs of
  ``zkt_plonk_tpu.ops.ntt_host`` at 2^10;
* coset4_fft / coset4_ifft against jitted JAX at 2^6 with n+4 coefficients;
* the fused pass (``ntt_mr.fused_pass_plain``, K3's plain version) against
  the chain it replaced (``col_pass_plain``, the table multiply, the
  permute) at every pass of a 3-pass plan at 2^15 with two polynomials,
  in all four directions, and the 2^15 transforms against the host ints.

Exact equality of limbs throughout.
"""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkt_plonk_tpu.fields import BN254_FR
from zkt_plonk_tpu.fields.limbs import array_to_ints, ints_to_array
from zkt_plonk_tpu.ops import ntt as jntt
from zkt_plonk_tpu.ops import ntt_host as jntt_host
from zkt_plonk_tpu.ops import ntt_mr as jntt_mr
from zkt_plonk_tpu.utils.domain import make_domain as jax_make_domain
from zkt_plonk_tpu_torch.fields import cuda as fc
from zkt_plonk_tpu_torch.ops import ntt, ntt_mr
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


P = BN254_FR.modulus
DIRECTIONS = ["fft", "ifft", "coset_fft", "coset_ifft"]


def _rand(shape, seed):
    rng = random.Random(seed)
    n = int(np.prod(shape))
    arr = ints_to_array([rng.randrange(P) for _ in range(n)], 16)
    return arr.reshape(*shape, 16)


@pytest.mark.parametrize("inverse,coset", [(False, False), (True, False), (False, True), (True, True)])
def test_plan_tables_match_jax(inverse, coset):
    ref = jntt_mr.build_plan(jax_make_domain(BN254_FR, 1 << 10), inverse=inverse, coset=coset)
    got = ntt_mr.build_plan(make_domain(BN254_FR, 1 << 10), inverse=inverse, coset=coset)
    assert got.factors == ref.factors and got.n == ref.n
    for a, b in zip(got.bitrevs, ref.bitrevs):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.stage_tws, ref.stage_tws):
        np.testing.assert_array_equal(a, b)
    pairs = list(zip(got.post, ref.post)) + [(got.pro, ref.pro), (got.epi, ref.epi)]
    for ts_got, ts_ref in pairs:
        assert len(ts_got) == len(ts_ref)
        for t_got, t_ref in zip(ts_got, ts_ref):
            assert (t_got.k, t_got.m, t_got.slice_) == (t_ref.k, t_ref.m, t_ref.slice_)
            np.testing.assert_array_equal(t_got.arr, t_ref.arr)


@pytest.fixture(scope="module", params=[6, 9], ids=lambda k: f"2^{k}")
def jax_transforms(request):
    logn = request.param
    n = 1 << logn
    x = _rand((2, n), seed=logn)
    plan = jax_make_domain(BN254_FR, n).plan()
    spec = jax_make_domain(BN254_FR, n).spec

    @jax.jit
    def run(pl, v):
        return tuple(getattr(jntt, d)(spec, pl, v) for d in DIRECTIONS)

    outs = [np.asarray(o) for o in run(plan, jnp.asarray(x))]
    return n, x, dict(zip(DIRECTIONS, outs))


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_transforms_match_jax(jax_transforms, direction):
    n, x, want = jax_transforms
    dom = make_domain(BN254_FR, n)
    got = getattr(ntt, direction)(dom.spec, dom.plan("cpu"), torch.from_numpy(x.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want[direction].astype(np.int32))


def test_transforms_match_host_ints_2_10():
    n = 1 << 10
    dom = make_domain(BN254_FR, n)
    plan = dom.plan("cpu")
    vals = array_to_ints(_rand((n,), seed=10))
    x = torch.from_numpy(ints_to_array(vals, 16).astype(np.int32))
    w, g = dom.group_gen, dom.coset_gen
    assert array_to_ints(ntt.fft(dom.spec, plan, x).numpy()) == jntt_host.fft_ints(vals, w, P)
    assert array_to_ints(ntt.ifft(dom.spec, plan, x).numpy()) == jntt_host.ifft_ints(vals, w, P)
    assert array_to_ints(ntt.coset_fft(dom.spec, plan, x).numpy()) == jntt_host.coset_fft_ints(
        vals, g, w, P
    )
    gi = pow(g, -1, P)
    want = [c * pow(gi, i, P) % P for i, c in enumerate(jntt_host.ifft_ints(vals, w, P))]
    assert array_to_ints(ntt.coset_ifft(dom.spec, plan, x).numpy()) == want


def test_coset4_matches_jax():
    n = 1 << 6
    jdom = jax_make_domain(BN254_FR, n)
    coeffs = _rand((3, n + 4), seed=4)
    evals = _rand((2, 4, n), seed=5)

    @jax.jit
    def run(pl, q4, c, e):
        return jntt.coset4_fft(jdom.spec, pl, q4, c), jntt.coset4_ifft(jdom.spec, pl, q4, e)

    want_f, want_i = run(jdom.plan(), jdom.quarter_plan(), jnp.asarray(coeffs), jnp.asarray(evals))
    dom = make_domain(BN254_FR, n)
    plan, q4 = dom.plan("cpu"), dom.quarter_plan("cpu")
    got_f = ntt.coset4_fft(dom.spec, plan, q4, torch.from_numpy(coeffs.astype(np.int32)))
    got_i = ntt.coset4_ifft(dom.spec, plan, q4, torch.from_numpy(evals.astype(np.int32)))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f).astype(np.int32))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i).astype(np.int32))


def test_col_pass_plain_is_one_radix_pass():
    """K3's radix-F pass at F = 8: rows gathered in bit-reversed order, then
    an 8-point DFT down each column (stage twiddles of the plan)."""
    dom = make_domain(BN254_FR, 8)
    tws = ntt_mr.build_plan(dom, inverse=False, coset=False).stage_tws[0][:, :, 0]
    x = _rand((8, 3), seed=8)
    got = ntt_mr.col_pass_plain(
        dom.spec, torch.from_numpy(x.astype(np.int32)), torch.from_numpy(tws.astype(np.int32))
    )
    cols = [array_to_ints(x[:, m]) for m in range(3)]
    w = dom.group_gen
    want = [[sum(c[t] * pow(w, t * k, P) for t in range(8)) % P for k in range(8)] for c in cols]
    assert [array_to_ints(got[:, m].numpy()) for m in range(3)] == want


def test_words_round_trip():
    """Packed words (the card's intermediates, values below 2p) back to
    canonical limbs, and the plan's Montgomery words back to the table."""
    dom = make_domain(BN254_FR, 8)
    vals = [0, 1, P - 1, P, P + 1, 2 * P - 1, random.Random(3).randrange(P)]
    words = ntt_mr.limbs_to_words(torch.from_numpy(ints_to_array(vals, 16).astype(np.int32)))
    assert words.shape == (len(vals), 8) and words.dtype == torch.int32
    assert array_to_ints(ntt_mr.words_canonical(dom.spec, words).numpy()) == [v % P for v in vals]
    host = ntt_mr.build_plan(dom, inverse=False, coset=False)
    mont = ntt_mr._from_mont(dom.spec, dom.plan("cpu").fwd.stage_tws[0])
    np.testing.assert_array_equal(mont.numpy(), host.stage_tws[0][:, :, 0].astype(np.int64))


N15 = 1 << 15


def _old_table(spec, tbls, M):
    """The product of a pass's compact tables as canonical (rows, M, L) limbs."""
    full = None
    for t in tbls:
        arr = torch.from_numpy(t.expand(M).astype(np.int64))
        full = arr if full is None else fc.mul64(spec, full, arr)
    return full


@pytest.mark.parametrize("inverse,coset", [(False, False), (True, False), (False, True), (True, True)])
def test_fused_pass_plain_matches_old_chain(inverse, coset):
    """Each fused pass equals col_pass_plain, then the table multiply, then
    the permute (the chain the transform ran before K3 took them in), at 2^15 = (7, 4, 4)
    with two polynomials; the coset prologue/epilogue and the 1/n of the
    pass D-2 table included."""
    nb, L = 2, 16
    dom = make_domain(BN254_FR, N15)
    spec = dom.spec
    host = ntt_mr.build_plan(dom, inverse=inverse, coset=coset)
    assert host.factors == (7, 4, 4)
    plan = getattr(dom.plan("cpu"), {(False, False): "fwd", (True, False): "inv",
                                     (False, True): "coset_fwd", (True, True): "coset_inv"}[inverse, coset])
    if inverse:
        n_inv = ntt_mr._from_mont(spec, plan.tout[1][:1, :1])
        assert array_to_ints(n_inv.reshape(1, L).numpy()) == [dom.size_inv]
    X = torch.from_numpy(_rand((nb, N15), seed=15).astype(np.int32))
    Fs = plan.Fs
    x = X.reshape(nb, Fs[0], N15 // Fs[0], L).permute(1, 0, 2, 3).reshape(Fs[0], -1, L)
    new_in = X
    Q, P_ = N15, 1
    for d, F in enumerate(Fs):
        Q //= F
        M = N15 // F
        if d == 0 and host.pro:
            rev = torch.from_numpy(host.bitrevs[0].astype(np.int64))
            pro = _old_table(spec, host.pro, M).index_select(0, rev)
            x = fc.mul64(spec, x.reshape(F, nb, M, L).to(torch.int64), pro[:, None]).reshape(F, nb * M, L)
        tws = torch.from_numpy(host.stage_tws[d][:, :, 0].astype(np.int32))
        x = ntt_mr.col_pass_plain(spec, x.to(torch.int32), tws)
        tables = host.post[d] if d < len(Fs) - 1 else host.epi
        if tables:
            tbl = _old_table(spec, tables, M)
            x = fc.mul64(spec, x.reshape(F, nb, M, L).to(torch.int64), tbl[:, None]).reshape(F, nb * M, L)
        if d < len(Fs) - 1:
            Fn = Fs[d + 1]
            x = x.reshape(F, nb, Fn, Q // Fn, P_, L).permute(2, 1, 3, 0, 4, 5).reshape(Fn, -1, L)
        else:
            x = x.reshape(F, nb, M, L).permute(1, 0, 2, 3).reshape(nb, N15, L)
        P_ *= F
        got = ntt_mr.fused_pass_plain(spec, plan, d, new_in, nb)
        np.testing.assert_array_equal(got.numpy(), x.to(torch.int32).numpy(), err_msg=f"pass {d}")
        new_in = got


@pytest.fixture(scope="module")
def host_vals_2_15():
    return array_to_ints(_rand((N15,), seed=16))


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_transforms_match_host_ints_2_15(host_vals_2_15, direction):
    vals = host_vals_2_15
    dom = make_domain(BN254_FR, N15)
    w, g = dom.group_gen, dom.coset_gen
    x = torch.from_numpy(ints_to_array(vals, 16).astype(np.int32))
    got = array_to_ints(getattr(ntt, direction)(dom.spec, dom.plan("cpu"), x).numpy())
    if direction == "fft":
        want = jntt_host.fft_ints(vals, w, P)
    elif direction == "ifft":
        want = jntt_host.ifft_ints(vals, w, P)
    elif direction == "coset_fft":
        want = jntt_host.coset_fft_ints(vals, g, w, P)
    else:
        gi = pow(g, -1, P)
        want = [c * pow(gi, i, P) % P for i, c in enumerate(jntt_host.ifft_ints(vals, w, P))]
    assert got == want
