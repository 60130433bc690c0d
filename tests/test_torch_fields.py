"""The port's field arithmetic (``zkt_plonk_tpu_torch.fields.device``, plain
CPU versions of kernels K1/K2) against the JAX package's
``zkt_plonk_tpu.fields.device`` on BN254 Fr and Fq.

Inputs are random (fixed seeds) plus the adversarial pairs of
``tests/test_pallas.py``; the tolerance is exact equality of the limbs.
"""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkt_plonk_tpu.fields import BN254_FQ, BN254_FR
from zkt_plonk_tpu.fields import device as jfd
from zkt_plonk_tpu.fields import make_spec as jax_make_spec
from zkt_plonk_tpu.fields.limbs import array_to_ints, ints_to_array
from zkt_plonk_tpu_torch.fields import cuda as tfc
from zkt_plonk_tpu_torch.fields import device as tfd
from zkt_plonk_tpu_torch.fields import make_spec


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


FIELDS = [BN254_FR, BN254_FQ]


def _pairs(p, seed):
    rng = random.Random(seed)
    pairs = []
    for tgt in [0, 1, 2, 3, p - 1, p - 2, p - 3]:
        for _ in range(4):
            a = rng.randrange(1, p)
            pairs.append((a, tgt * pow(a, -1, p) % p))
    fixtures = [0, 1, 2, p - 1, p - 2, (p - 1) // 2, (p + 1) // 2]
    fixtures += [((1 << k) - 1) % p for k in range(16, 16 * 16 + 1, 16)]
    fixtures += [(1 << k) % p for k in range(15, 16 * 16, 16)]
    pairs += [(x, y) for x in fixtures for y in fixtures]
    pairs += [(rng.randrange(p), rng.randrange(p)) for _ in range(200)]
    return [a for a, _ in pairs], [b for _, b in pairs]


def _t(ints):
    return torch.from_numpy(ints_to_array(ints, 16).astype(np.int32))


@pytest.fixture(scope="module", params=FIELDS, ids=lambda f: f.name)
def field(request):
    params = request.param
    p = params.modulus
    a, b = _pairs(p, 1234)
    jspec = jax_make_spec(params)

    @jax.jit
    def ref(x, y):
        return (
            jfd.add(jspec, x, y),
            jfd.sub(jspec, x, y),
            jfd.mul(jspec, x, y),
            jfd.neg(jspec, x),
        )

    A = jnp.asarray(ints_to_array(a, 16))
    B = jnp.asarray(ints_to_array(b, 16))
    want = [np.asarray(r) for r in ref(A, B)]
    return params, a, b, want


@pytest.mark.parametrize("op", ["add", "sub", "mul", "neg"])
def test_binops_match_jax(field, op):
    params, a, b, want = field
    spec = make_spec(params)
    A, B = _t(a), _t(b)
    got = tfd.neg(spec, A) if op == "neg" else getattr(tfd, op)(spec, A, B)
    idx = ["add", "sub", "mul", "neg"].index(op)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want[idx].astype(np.int32))


@pytest.mark.parametrize("params", FIELDS, ids=lambda f: f.name)
def test_pow_const_and_inv_match_python(params):
    spec = make_spec(params)
    p = params.modulus
    rng = random.Random(7)
    xs = [0, 1, p - 1] + [rng.randrange(p) for _ in range(13)]
    X = _t(xs)
    for e in (0, 1, 5, (1 << 40) + 3, p - 2):
        got = array_to_ints(tfd.pow_const(spec, X, e).numpy())
        assert got == [pow(x, e, p) for x in xs], e
    assert array_to_ints(tfd.inv(spec, X).numpy()) == [pow(x, p - 2, p) for x in xs]


PR = BN254_FR.modulus
POW_EXPONENTS = {
    "1": 1, "2": 2, "3": 3, "5": 5, "(p-1)/2": (PR - 1) // 2, "p-2": PR - 2,
    # dense low bits (a window of several bits pays), but the top window is
    # cut short by the zeros below the leading 1
    "partial-top": (1 << 100) | 0x9E3779B97F4A7C15F39CC061,
}


@pytest.mark.parametrize("name", list(POW_EXPONENTS))
def test_pow_chain_windowed_matches_python(name):
    """K2's plain version (the sliding-window chain the kernel runs) against
    pow(a, e, p) for a in {0, 1, p-1, random}, on Fr and Fq; and its
    schedule replayed on the exponent."""
    e = POW_EXPONENTS[name]
    sched = tfc.window_schedule(e)
    acc = 2 * sched.first + 1
    for squarings, idx in sched.steps:
        assert idx < sched.ntab
        acc = (acc << squarings) + 2 * idx + 1
    assert acc << sched.tail == e
    binary = e.bit_length() - 1 + bin(e).count("1") - 1
    assert sched.products() <= binary
    if name == "partial-top":
        assert sched.window > 1 and 2 * sched.first + 1 < 1 << (sched.window - 1)
    for params in FIELDS:
        p = params.modulus
        xs = [0, 1, p - 1] + [random.Random(e % 1000).randrange(p) for _ in range(3)]
        got = tfc.pow_chain_plain(make_spec(params), _t(xs), e)
        assert got.dtype == torch.int32
        assert array_to_ints(got.numpy()) == [pow(x, e, p) for x in xs]


def test_pow_chain_schedule_is_shorter_than_binary():
    """For the Fermat exponent the window chain needs ~70 fewer products
    than square-and-multiply (309 against 379 for BN254 Fr)."""
    sched = tfc.window_schedule(PR - 2)
    assert sched.window in (4, 5)
    assert sched.products() <= 379 - 60


@pytest.fixture(scope="module")
def jax_scans():
    """JAX's batch inverse and prefix products on BN254 Fr (one compile)."""
    jspec = jax_make_spec(BN254_FR)
    rng = random.Random(21)
    xs = [rng.randrange(BN254_FR.modulus) for _ in range(37)]
    xs[5] = xs[30] = 0

    @jax.jit
    def ref(x):
        return jfd.batch_inverse(jspec, x), jfd.prefix_products(jspec, x)

    out = ref(jnp.asarray(ints_to_array(xs, 16)))
    return xs, [np.asarray(r).astype(np.int32) for r in out]


def test_scans_match_jax(jax_scans):
    xs, (w_inv, w_pre) = jax_scans
    spec = make_spec(BN254_FR)
    T = _t(xs)
    np.testing.assert_array_equal(tfd.batch_inverse(spec, T).numpy(), w_inv)
    np.testing.assert_array_equal(tfd.prefix_products(spec, T).numpy(), w_pre)


@pytest.mark.parametrize("params", FIELDS, ids=lambda f: f.name)
def test_scans_match_python(params):
    """batch_inverse (any axis), prefix_products and powers against Python
    ints — the same functions as JAX's (compared on Fr above)."""
    spec = make_spec(params)
    p = params.modulus
    rng = random.Random(22)
    xs = [rng.randrange(p) for _ in range(36)]
    xs[4] = 0
    T = _t(xs)
    want_pre, acc = [], 1
    for x in xs:
        acc = acc * x % p
        want_pre.append(acc)
    assert array_to_ints(tfd.prefix_products(spec, T).numpy()) == want_pre
    got = tfd.batch_inverse(spec, T.reshape(4, 9, 16), axis=1).reshape(36, 16)
    assert array_to_ints(got.numpy()) == [pow(x, -1, p) if x else 0 for x in xs]
    assert array_to_ints(tfd.powers(spec, T[3], 11).numpy()) == [pow(xs[3], i, p) for i in range(11)]


def test_wrappers_reject_bad_operands():
    spec = make_spec(BN254_FR)
    x = _t([1, 2, 3])
    with pytest.raises(TypeError):
        tfd.mul(spec, x.to(torch.int64), x)
    with pytest.raises(ValueError):
        tfd.mul(spec, x[:, :8], x[:, :8])


def test_default_device_is_the_card():
    spec = make_spec(BN254_FR)
    if torch.cuda.is_available():
        assert tfd.zeros(spec, (2,)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tfd.zeros(spec, (2,))
